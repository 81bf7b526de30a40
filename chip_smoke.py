"""Drive the PyTorch port's flagship serving path, and its other apps, on
one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. check that a CUDA card is there, and print its name and power limit;
2. build the CUDA kernels from ``keystone_tpu_torch/csrc`` (nvcc, sm_90a)
   and print what ptxas reports of each: registers, shared memory, spills;
   count the HMMA instructions in B3's kernels (cuobjdump) and require
   them in its tiled path's two passes;
3. hold each kernel against its plain PyTorch version on the card, at
   ragged shapes (random dense operators, and real SIFT and LCS operators
   cropped so their bands straddle the kernels' tiles, with a tile of zero
   rows and a group of zero columns) and at the full-width shapes of the
   serving path (B = 64 images of 256x256), and time the kernel, the plain
   version and a one-call PyTorch yardstick with CUDA events around runs
   of 10 calls in a row (``compare_kernels.time_ms``), so that the host's
   launch time hides behind the device's work; each bound counts the FLOPs
   of the operators' nonzero bands (the dense count is kept beside it);
   past the kernels' old limits, B1 at W = 1,024 and 2,048 (dense, and one
   scale's real SIFT operators of a 1,536 x 2,048 and a 2,048 x 300
   image), B2 at W = 2,048 (dense, and real LCS operators with and
   without their bands), B3 at (d, k) = (64, 256), (80, 256) and
   (129, 257) at m = 1, 1,500 and 13,165 and at (64, 1,100), past the
   old bound on k, at m = 1,500, each timed beside its bound (B3's rows
   also beside a tensor-core bound, with their cp.async copy width; the
   phase-8 pair and the VOC chunk's shape by kernel, from
   a Kineto session), and ``TopKClassifier`` on tied rows
   against a stable host sort;
4. serve the ImageNetSiftLcsFV configuration (SIFT step 3 / bin 4 /
   4 scales, LCS 4/16/6, desc_dim 64, vocab 32 → 8,192 features, a
   seeded 8,192 x 1,000 linear head, top-5) through buckets (8, 64) of
   the serving engine, one CUDA graph per bucket captured at ``warmup``,
   check every kernel's launch count (4 / 1 / 2 per dispatch, counted
   per replay), and hold the first 8 images' features and top-5 against
   a CPU run of the port (plain versions);
5. time examples/sec per bucket, and profile one bucket-64 dispatch: device
   busy time with and without the copies, the pinned host-to-device
   copy, the idle share, and the port's kernels in it;
6. train, then serve: fit ImageNetSiftLcsFV on the card as
   ``pipelines.images.imagenet_sift_lcs_fv.run`` does (``build_pipeline``
   and ``fit``: PCA, GMM EM and the mixture-weighted solver; vocab 32,
   1,000 classes) on 2,000 seeded synthetic 256² images, 2 per class, and
   classify 1,000 held-out ones;
   check that the fit launched every kernel; hold each estimator on the
   card against the port on the CPU on the same inputs (both PCA
   matrices, both GMMs, the solver on its first 512 rows with PCG and
   with Cholesky, the Cholesky fit's CPU side in a process of its own
   beside phases 7 to 13 and held against the card's after phase 13), and
   B3 against its plain version with the fitted GMMs;
   require a held-out top-5 error of at most 0.5; serve the trained chain
   through buckets (8, 64) and require the fitted pipeline's top-5. Prints
   the wall time of each stage and the peak device memory;
7. serve phase 4's chain and head under a request stream: capture buckets
   (8, 64) at ``warmup`` (compile count 2; capture seconds and graph-pool
   bytes per bucket); hold replays against the eager chain (top-5 equal,
   features at phase 4's bar) and their launches; run bursts of exactly
   64 single-image requests through ``MicroBatcher`` serial and pipelined
   (``pipeline_depth=2``) and require every future's row bit for bit
   equal across the modes and to ``engine.apply``; drive a closed loop of
   128 single requests in flight (8 client threads of 16) for 4 s per
   mode, at the batcher's default max_delay_ms of 5 and at 25, and print
   requests/s, request p50/p99, the mean coalesced size, the stage means,
   the bottleneck stage, the overlap efficiency and the staging bytes;
   then phase 5's throughput and profile once more;
8. real image files: write a train and a test tar of seeded JPEGs (PIL,
   quality 90; 12 WNIDs, 10 training and 3 test images each, at 375 x
   500, 500 x 375 and 333 x 500, with 2 + 2 at 768 x 1,024 and 1 + 1 at
   1,536 x 2,048) and a WNID file under ``chiprun_out/phase8``; run
   ``ImageNetSiftLcsFV.main`` on them on the card at vocab 32 (the
   images decoded at their native sizes, one batch per size); require
   every kernel launched and B1 and B2 launched wider than their old
   limits; hold the features of 4 test images of different sizes
   against the port on the CPU, through the serving chain's seeded warm
   start at the serving bar and through the fitted parameters (top-5
   equal, and to the fitted pipeline's; features at the fitted-GMM bar);
   then stream the training tar at 256² through
   ``StreamingImageNetLoader.featurized_batches`` into a serving engine of
   the featurize chain at the paper's vocabulary, 256 (B3 at k = 256),
   hold its first 8 rows against the CPU port, and print decode images/s
   and featurize examples/s.
9. VOCSIFTFisher at the paper's widths: write a train and a test tar of
   seeded JPEGs (240 and 120, at 375 x 500, 500 x 375 and 333 x 500; 1 to
   3 of 20 classes an image, each class a textured band) and the VOC
   labels CSV under ``chiprun_out/phase9``; run ``VOCSIFTFisher.main`` on
   the card (desc_dim 80, vocab 256, lambda 0.5, block 4,096 -> 40,960
   features); require B1 and B3 launched in the fit and in the scoring
   pass and a MAP above chance; hold the fitted chain's features of 4 test
   images against the CPU (phase 8's fitted-chain bar) and the solver
   against a CPU fit of the same features; fit again from host column
   blocks (``Dataset.host_blocks_from_batches``) and require the in-memory
   fit's W, a peak under ``host_block_budget`` and the blockwise apply
   equal to the dense one; save the fitted
   pipeline and require a fresh ``python3`` process that loads it to
   score the test tar bit for bit as this one did, with the same MAP;
   time B3 at one 375 x 500 image's descriptors with the fitted GMM, and
   at the fit's chunk of 64 such images.
10. the random-features image apps, which reach no kernel of this repo
   (each kernel's launches in the phase are counted and printed: 0):
   write CIFAR binary records of 50,000 + 10,000 seeded images
   (``synthetic_cifar``'s color blobs, and LinearPixels' spatial
   patterns) and MNIST-layout CSVs of 60,000 + 10,000 seeded rows under
   the gitignored ``tmp/phase10``; run ``RandomPatchCifar.main`` (the JAX
   defaults: 100 filters, patch 6, pool 14/13, a 100,000-row whitener
   sample), print its time by node and its peak device memory, hold the
   Convolver of 256 test images and their classes against the port on
   the CPU with the card's fitted parameters; run the KRR variant (gamma 2e-5, block 512,
   1 epoch), then 2 epochs with and without the cached kernel (equal
   within the JAX test's bar), and hold a 2,048-row fit against the CPU
   and the device solve against the host one; run
   ``MnistRandomFFT.main`` (4 FFTs, block 2,048) fused, and its gathered
   branches, and hold their features together; run LinearPixels and
   RandomCifar at the full sizes and the augmented variants at 5,000 +
   1,000 images; each app must beat its JAX test's accuracy bar; serve
   ``build_featurize_pipeline``'s 16² conv stack through buckets (8, 64),
   replays bit for bit the eager chain, and time it as phase 5 does.
11. fits past the card's memory, the flagship's other estimators, and
   TIMIT: (a) phase 6's configuration at the paper's vocabulary, 256
   (65,536 features): fit the featurizer on 1,000 seeded images, stream
   4,000 and then 16,000 images (made on the card a chunk at a time)
   through it in chunks of 64 into ``Dataset.host_blocks_from_batches``
   and fit the weighted solver from the host blocks; print the images/s,
   the kernels' launches per chunk, the solver's seconds and each fit's
   peak device memory, require the peak's growth between the sizes to be
   the slabs and the solver's (n x classes) arrays, not the features,
   hold the host-block fit against an in-device fit of the same features
   and score 1,000 held-out images (top-5 error at most 0.5); (b) phase
   6's fit under ``AutoCachingOptimizer("greedy")`` against the default
   optimizer: the cache decision, both fits' time and peak, held-out
   top-5 equal; (c) ``PerClassWeightedLeastSquaresEstimator`` and the
   block-weighted solver on phase 9's features (training argmax accuracy
   above 0.95), ``ApproximatePCAEstimator`` at the SIFT PCA's shape (128
   -> 64; principal-angle cosines above 0.99 against the exact PCA on
   rank-64 data at the JAX defaults and on phase 6's descriptor sample at
   16 power iterations; the defaults' angle there printed); (d)
   ``timit.main`` with the JAX defaults (40 x 4,096 cosines) on
   TIMIT-layout files of 32,768 + 8,192 seeded frames under the gitignored
   ``tmp/phase11``: accuracy above 0.9, time and peak.
12. the text apps and the ELL solver, which reach no kernel of this repo
   (the launches in the phase are counted and printed: 0): (a)
   ``NewsgroupsPipeline.main`` with the JAX defaults (2-grams, 100,000
   common features, 20 classes) on 5,657 + 3,766 seeded documents of 250
   words written as per-class directories under the gitignored
   ``tmp/phase12``, string-keyed and ``--hashing``: accuracy above 0.9,
   time by node and peak, Naive Bayes card against CPU, the native
   featurizer's routes (every document native), and the string-keyed
   pipeline saved, reloaded and scoring the test split bit for bit; (b)
   ``AmazonReviewsPipeline.main`` (threshold 3.5, 2-grams, 100,000
   features, 20 iterations) on JSON lines of 12,500 + 2,500 reviews
   string-keyed and 250,000 + 50,000 hashed, 100 words each: accuracy,
   L-BFGS iterations and value-and-gradient calls, nnz and CSR bytes, fit
   seconds and peak, and the string-keyed fit against a CPU fit; (c)
   ``EllLeastSquaresEstimator`` at bench.py's 65,000,000 x 1,024, nnz 5,
   K 2, lambda 1e-2, bf16 data made on the card: fit seconds, Gram
   TFLOP/s, peak, G and AᵀY of the first 1,000,000 rows against float64
   and the mapper against the dense product.
13. the last app and the remaining operators, which reach no kernel of
   this repo (the launches in the phase are counted and printed: 0): (a)
   ``StupidBackoffPipeline.main`` on a seeded Zipf corpus of 20,000 lines
   of 20 words over 200,000 words written under the gitignored
   ``tmp/phase13``, 1,000 sampled scores against a direct count over the
   corpus, then ``python -m keystone_tpu_torch StupidBackoffPipeline`` in a
   fresh process (exit 0, the same printed line); (b) ``CRFNEREstimator``
   for 50 epochs (the JAX default's quarter) on 14,041 seeded sentences of CoNLL-2003 train's
   203,621 tokens (longest 113, 9 BIO tags), decoded on 3,453: the fit's
   seconds, epochs and steps/s, one training step eager and as a CUDA
   graph replay, decode sentences/s, token accuracy beside
   ``rule_ner_tag``'s (the JAX tests' bars), no BIO-invalid path, the
   parameters after 5 epochs on 512 sentences against the CPU; then
   ``CRFTaggerEstimator`` at 45 tags on the same shape for 25 epochs,
   above each word's majority tag; (c) HOG (bin 8) and DAISY on 64 seeded images of 500 x
   375 and on four mixed sizes: images/s, two images against the CPU
   under the golden bar; (d) ``gram`` and ``qr_q`` at 1,048,576 x 1,024
   float32: ms, max|QᵀQ − I|, ‖QR − A‖/‖A‖, ``gram`` against float64 on
   65,536 rows, and of bf16 rows (float32 out); ``device_shuffle`` of
   those rows against the host ``Shuffler``'s.
14. the request plane over HTTP: (a) phase 4's chain and head behind
   ``Gateway(buckets=(8, 64), n_lanes=2, pipeline_depth=2,
   max_delay_ms=5)`` and ``GatewayServer`` on an ephemeral port, loaded by
   64 clients in flight in a separate ``python3`` (closed loop, 8 s,
   JSON bodies of single 256² images encoded before the window): every
   response's top-5 equal to the direct chain's at its bucket, req/s and
   client p50/p99, admit → result and queue wait read back from
   ``/metrics``, the JSON decode of one body alone, the mean coalesced
   size, sheds, B1–B3 launches per dispatch (exactly 4 / 1 / 2), the
   graph pools' bytes, and the device's idle share over a 2 s
   Kineto window of every thread (``utils/profiling.trace``); (b) under the same load
   ``POST /swap`` (no failed request across it; the new generation's
   capture seconds and the peak reserved memory of two generations),
   ``/profilez`` (its trace names B1–B3), ``/metrics`` (the gateway
   families and ``keystone_device_memory_bytes``), ``/slz``, ``/debugz``,
   then ``POST /drain`` (``/readyz`` 503, every admitted request
   resolved); (c) ``python -m keystone_tpu_torch --admin-port 0
   serve-gateway --gateway-port 0 --device-featurize flagship --img 256
   --buckets 8,64 --lanes 2`` in a fresh process: one POST, the
   process's first ``/profilez`` under 64 clients (its trace names B1
   and B2, which the entry's chain launches), the admin endpoint's
   ``/metrics`` and ``/healthz``, SIGTERM, exit 0, and its start split
   (the listening line's ``start_s``: no profiler step of 0.5 s or more,
   and the first ``/profilez``'s own seconds: no step before it either);
   (d) the weighted solver on phase 6's features cast to bf16
   against the float32 fit of the same values, ``Convolver(fast=True)``
   against ``fast=False`` at RandomPatchCifar's shape (8e-3 of the
   largest feature), with both times, and the filter convolution alone
   with bf16 operands against float32 (why ``fast`` runs float32).
15. the fleet tier and the model zoo: (a) ``serve-router`` and two
   ``serve-gateway --device-featurize flagship --img 256 --trace
   --register`` replicas, each a ``python -m keystone_tpu_torch`` process
   of its own, the two started together, every one exporting spans to a
   stdlib OTLP collector in this process: a routed and a direct answer
   against the eager chain here, the router's stitched ``/debugz`` of a
   routed request (both tiers, not partial, phases summing to the total
   within 1 ms), 64 clients for 5 s through the router and straight at
   one replica (req/s, p50/p99, each replica's share, every answer
   right), the federated ``/metrics`` count against the replicas' own,
   ``kill -9`` of one replica under load and its restart on its port (no
   failed request; ``/fleetz`` shows it unhealthy, then healthy), SIGTERM
   (deregistered, exit 0), and spans from all three processes with their
   ``service.name`` and ``replica``; (b) ``serve-gateway --zoo`` with two
   flagship models of one featurize chain and the demo model,
   ``--optimize --max-resident 2``, registered with that router:
   ``/planz`` shows one shared unit, ``/predict/<model>`` through the
   router, ``/attributionz`` shares summing to 1, ``/driftz`` flagging
   the demo model after a shifted size mix; in this process, the shared
   unit's one graph per bucket, its replay launching B1 and B2 as often
   as a solo flagship replay, each head within rtol 1e-4 / atol 1e-5 of
   its solo engine, the featurize token alike on the card and the CPU,
   and an LRU cycle (page-in and eviction seconds, reserved and allocated
   memory); (c) ex/s at bucket 64 of the shared unit against two solo
   units serving both models.
16. the load generator and the online model lifecycle: (a) phase 4's
   chain and head (B1–B3) behind ``Gateway`` and ``GatewayServer`` with a
   request log, float32 instances (the loadgen's payloads are float32
   normals, which a uint8 server refuses): a trace recorded from 8 of
   phase 14's uint8 clients, 100 of its POSTs replayed open-loop by
   ``python -m keystone_tpu_torch serve-loadgen --target URL --trace
   FILE`` at 2.5 req/s with ``gateway.lane.kill`` armed over ``/chaosz``
   12 s into the run for 10 s (smoke-chaos's other bounds): a green
   verdict, at least 20 requests before, during and after the fault, the
   injection on ``/metrics``, B1–B3 launched in this process during the
   replay, offered (from the arrivals) and served req/s, the server's
   p50/p99, the seconds to p99 recovery; (b) ``serve-gateway
   --refit --d 256 --hidden 512 --depth 4`` in a process of its own fed by
   ``serve-loadgen --feedback-fraction 0.5 --teacher
   hidden=512,depth=4,head_seed=7`` at 150 req/s: ``/lifecyclez`` walks
   idle → shadow → canary → promoted, then ``lifecycle.refit.poison``
   armed over ``/chaosz`` rolls back the first candidate solved from
   poisoned samples (reason and counter), verdicts green, SIGTERM exit 0; in this process the same
   gateway and controller ticked by hand under 150 req/s: a candidate's
   build and each swap's seconds, outputs after a post-promotion
   rollback bitwise equal to the incumbent's, a poisoned candidate
   rolled back within one tick of its shadow start, and
   ``memory_allocated`` after it within one version's graph pools of the
   baseline; (c) ``serve-loadgen --self-gateway --synthetic 2000
   --arrivals lognormal --rate 400`` in this process (green), and the
   same generator over the same gateway once more: open-loop p50/p99.
17. cold start, model sharding and elasticity: (a) the start-up split
   (import, CUDA init, kernel build or load, model, operators, warmup)
   of phase 4's engine in a fresh process, cold (a fresh build directory:
   nvcc) and from the AOT store, and of ``serve-gateway
   --device-featurize flagship --aot-cache DIR`` started twice (cold,
   then from the store); (b) the AOT round trip: an engine in this
   process saves both buckets, the fresh process built from the store
   hits both and answers 64 images bit for bit as it (B1/B2/B3 4 / 1 / 2
   per replay), a corrupted entry is counted as an error and rebuilt on
   the card with equal answers, ``serve-aot-build`` fills a store for the
   gateway's flags, the second gateway start counts its hits on
   ``/metrics``; (c)
   ``Gateway(param_sharding=True)`` over phase 4's chain on a (1, 1)
   mesh (every resolved spec printed) answers as the unsharded gateway,
   ``serve-gateway --shard-model --mesh-model 1`` as 17b's, ``--mesh-model
   2`` exits non-zero with its reason; (d) ``serve-autoscale`` (1–2
   flagship replicas on 17b's store) under ``serve-loadgen --ramp`` of
   uint8 images through its router: a scale_up, the second replica
   serving, no failed request, a drain-retired replica after the load
   drops, SIGTERM draining every child, each replica's start seconds
   and B1/B2 launches; (e) ``serve-capacity-plan`` over replicas 1,2 x
   speeds 1,2: a fitted per-replica rate;
18. the port's tools, host only: ``python -m keystone_tpu_torch
   keystone-lint --json`` over the checkout must exit 0 and be clean;
   phase 3's kernel times, written as bench rows (``B1_ms`` ...) to a
   temporary directory, must pass ``bench-diff`` against themselves and
   fail it, naming B1 alone, against a copy with B1's time doubled;
19. ``python -m keystone_tpu_torch serve-bench --no-cold-start
   --no-pipeline-overlap`` and ``--featurize-only`` in fresh processes
   at the JAX defaults, once each: every row printed and the process
   exit 0 (so each row's own checks held), the goodput row's cost model
   and MFU, the flagship row's MFU and roofline for every bucket, and
   B1–B3 launched in the featurize process. The two rows left out miss
   their floors on the card whatever the port does: the cold-start row's
   3.0x (a fresh process's import, 8.6–11.2 s on the H100's host, is most of either start,
   and no store holds it; ROADMAP C8) and the overlap row's 1.2x (its
   fixed 10 ms prep wait leaves 1 + R/P of about 1.12 there; C9). Phase 4
   prints its engine's cost model per bucket (FLOPs, bytes and each
   kernel's FLOPs), and phase 5 requires ``keystone_serving_mfu`` and a
   roofline class per bucket on the engine's ``/metrics``. The featurize
   rows' host path runs ``featurize.jit_batch()``; their host rate and
   ``speedup_vs_host`` are printed;
20. ``FittedPipeline.jit_batch`` on phase 4's chain, one CUDA graph per
   batch shape: calls at 64 images, a ragged 37 and 64 again (captures
   1, 1, 0), each capture's seconds and pool bytes, B1/B2/B3 launches of
   4/1/2 a call (the capture tally), the outputs at 64 bit for bit
   against the engine's bucket-64 featurize graph and within the serving
   bar of eager ``_batch_run``, the 37 rows against the first 37 at 64,
   top-5 on phase 4's head equal to the engine's, ``jit()`` on one
   image, a replay at 64 timed beside the engine's and beside eager, and
   a chain with an items-mode node raising on the card;
21. the data-parallel layer (``parallel/{mesh,runtime,virtual}.py``):
   ``torch.cuda.device_count()`` processes, one card each, joined by NCCL
   through ``parallel.virtual.launch`` (the parent's cache emptied
   first). Each builds only its own rows of TIMIT at its published widths
   (440 → 40 x 4,096 cosines = 163,840 features, 147 classes) on phase
   11d's 32,768 seeded frames, each row from its global index, and fits
   ``BlockLeastSquaresEstimator(4096)`` on its shard in device memory (2
   sweeps) and from host blocks (1 sweep): W gathered and identical on
   every process, the training accuracy over every shard; rank 0 then
   fits the unsharded rows (after the sharded matrix is freed) and W must
   equal it bit for bit at one process (an ``all_reduce`` over one rank
   changes no bytes), within rtol 2e-4 / atol 2e-5 at more. Then
   ``qr_q`` at phase 13's 1,048,576 x 1,024 on sharded rows and
   ``device_shuffle`` at the world size. Prints the world size, each
   fit's seconds, the fits' ``all_reduce`` calls and bytes, and one
   block's ``all_reduce`` timed by CUDA events. In the same launch, the
   estimators that fit on sharded rows: (a) the flagship's weighted
   solver at phase 6's widths (2,000 seeded 256² images, each process
   featurizing its own through phase 4's chain and ``jit_batch``, 64 at a
   time, B1/B2/B3 4/1/2 launches a chunk; labels from phase 4's head;
   ``BlockWeightedLeastSquaresEstimator(4096, 1, 6e-5, 0.25)``, the pcg
   path), (b) the ELL solve at 12c's widths over 4,194,304 rows and (c)
   the per-class solver, logistic regression, the sketch PCA, KRR and
   dense L-BFGS at their CPU tests' sizes: each fit's seconds, its
   collectives (``all_reduce`` only: no fit gathers X), the model
   identical on every process and bit for bit rank 0's unsharded fit at
   one process; (a) also its peak memory and training top-1.
   ``python3 chip_smoke.py --data-parallel`` runs this phase alone.

Three options run one bench row N times in this process, each run's row
or the check it failed, then the count that passed (not phases):
``--overlap-runs N`` (``serving_pipeline_overlap``, with the lane's host
split by thread and the garbage collector's pauses, ``lane_split``),
``--cold-start-runs N`` (``serving_cold_start_aot``, with each fresh
``serve-gateway``'s start split) and ``--featurize-runs N``
(``serving_device_featurize``, its host path ``jit_batch``). ``--autoscale-runs N`` runs phase 17d's
drill N times, the autoscaler kept 15 s past each retire, with each
run's timeline. ``--featurize-processes N`` runs phase 19's featurize
process (``serve-bench --featurize-only``: both featurize rows) N times,
each in a fresh process under the gateway split (``lane_split`` by
lane: each measured pass's req/s, rows a window, each step's ms a
window from the batching wait to the window's cycle, each thread's
CPU ms a window and the collector's pauses), and counts the processes
that exited 0 (ROADMAP C11).

Prints the kernel table as one JSON line, then the card's name and power
limit, then, last, the result line ``{"ok": true, "device": {...}}``.
Writes the full record to ``chiprun_out/chip_smoke.json``. Imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tarfile
import threading
import time
from collections import Counter, deque

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from compare_kernels import time_ms  # noqa: E402
from keystone_tpu_torch import _cuda, convert  # noqa: E402
from keystone_tpu_torch.convert import model_head  # noqa: E402
from keystone_tpu_torch.ops.images import core, fisher_vector, fv_kernel, kernels, lcs, sift  # noqa: E402
from keystone_tpu_torch.ops.learning import block_ls, gmm, pca, weighted_ls  # noqa: E402
from keystone_tpu_torch.ops.stats import nodes as stats_nodes  # noqa: E402
from keystone_tpu_torch.parallel.dataset import Dataset  # noqa: E402
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as flagship  # noqa: E402
from keystone_tpu_torch.pipelines.images import voc_sift_fisher as voc  # noqa: E402
from keystone_tpu_torch.pipelines.images import cifar_apps as apps  # noqa: E402
from keystone_tpu_torch.pipelines.images import mnist_random_fft as mnist  # noqa: E402
from keystone_tpu_torch.pipelines.images import random_patch_cifar as rpc  # noqa: E402
from keystone_tpu_torch.loaders.cifar import CifarLoader, LabeledImages  # noqa: E402
from keystone_tpu_torch.loaders.csv_loader import LabeledData  # noqa: E402
from keystone_tpu_torch.ops.learning import kernel as krr  # noqa: E402
from keystone_tpu_torch.ops.util.nodes import ClassLabelIndicators, TopKClassifier  # noqa: E402
from keystone_tpu_torch.workflow.executor import PipelineEnv  # noqa: E402
from keystone_tpu_torch.serving import MicroBatcher, ServingMetrics  # noqa: E402
from keystone_tpu_torch.utils import profiling  # noqa: E402
from keystone_tpu_torch.utils.chunks import CHUNK_ROWS  # noqa: E402
from keystone_tpu_torch.workflow import api  # noqa: E402
from keystone_tpu_torch.serving.featurize import (  # noqa: E402
    build_featurize_pipeline,
    build_flagship_featurize_pipeline,
)

# H100 SXM data sheet, dense, at the 700 W limit: float32 on the CUDA
# cores, TF32 on the tensor cores, and HBM3 rate. bound_ms counts every
# kernel's operations at the float32 rate, as since PR 1; B3's tiled path
# runs its products on the tensor cores in 3xTF32 (three TF32 products for
# each float32 one), and its rows add bound_tc_ms at the TF32 rate
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

IMG, B = 256, 64
CONF = dict(
    img=IMG, desc_dim=64, vocab=32, sift_step=3, sift_bin=4, sift_scales=4,
    sift_scale_step=1, lcs_stride=4, lcs_border=16, lcs_patch=6, seed=7,
)
CLASSES, TOP_K = 1000, 5
BUCKETS = (8, 64)
REQUESTS = (1, 8, 37, 64)
RTOL_SANDWICH, ATOL_SANDWICH = 1e-4, 1e-4
RTOL_FV, ATOL_FV = 1e-3, 1e-4
RTOL_FEAT, ATOL_FEAT = 1e-4, 1e-5
# phase 8's fitted chain, card against CPU: the share of feature entries
# allowed past RTOL_FEAT / ATOL_FEAT, and the largest error of any entry
# (SIFT's ±1 quantization steps move near-threshold posteriors; PERF.md § 4)
FITTED_BEYOND_SHARE, FITTED_MAX_ABS = 0.005, 5e-3
# phase 7: the closed loop's client threads and requests in flight (each
# thread keeps its share of them), the batcher's max_delay_ms of each pair
# of runs (the default, then one that lets a pipelined lane fill its
# windows), and seconds per run (8 before phase 17)
STREAM_THREADS, STREAM_IN_FLIGHT, STREAM_DELAYS_MS, STREAM_S = 8, 128, (5.0, 25.0), 4.0

# phase 6: ImageNetSiftLcsFV at the serving phase's widths, trained
TRAIN_CONF = dict(
    desc_dim=64, vocab_size=32, lam=6e-5, mixture_weight=0.25,
    sift_scale_step=1, lcs_stride=4, lcs_border=16, lcs_patch=6,
    num_pca_samples_per_image=10, num_gmm_samples_per_image=10,
    num_classes=1000, seed=0,
)
TRAIN_PER_CLASS, NOISE_SIGMA = 2, 8.0
MAX_TOP5_ERR = 0.5
SOLVER_ROWS = 512
# the Cholesky solve's CPU side (68.4 s of phase 6 on eight threads of
# an H100 host) runs in a process of its own on this many threads
# beside phases 7 to 13; the card's fit is held against it after phase 13
CPU_SOLVER_THREADS = 2
P6_CPU_SOLVER_S = 900
# bars of the JAX package's tests: PCA tests/ops/test_pca_zca.py, GMM
# tests/ops/test_clustering.py, solvers tests/ops/test_weighted_ls.py
ATOL_PCA, TOL_GMM, ATOL_SOLVER = 5e-3, 1e-3, 5e-4
# and the solver's W and intercept as a whole: ‖card − CPU‖ / ‖CPU‖, a
# bar that scales with the solution (float32 rounding, amplified by the
# conditioning of a 512-row fit, stays far below it; a solver that stopped
# early or solved another system does not)
RTOL_SOLVER_NORM = 1e-3


def log(*a):
    print(*a, flush=True)


def bound(flops, nbytes):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# the kernels' work formulas, which their wrappers also report to the
# serving engine's cost model (observability/device.kernel_cost)
fv_flops = fv_kernel.fv_flops
band_flops = kernels.band_flops


def device_profile():
    """A Kineto session of host and device activity
    (``torch.autograd.profiler.profile``; ``torch.profiler.profile``
    would first import ``torch._inductor``, about 8 s on the card's
    host)."""
    return torch.autograd.profiler.profile(use_device="cuda", use_kineto=True)


def fv_by_kernel(xs, means, variances, weights, thresh=1e-4):
    """Device ms of each B3 kernel (the GMM terms, the tiled path's
    fragment split, norm and statistics passes, the reduction) over one
    call per x, from a ``device_profile`` session."""
    from torch.autograd import DeviceType

    # host and device activity, as phase 5's profile. Called in phase 3: in
    # phase 9, after the serving phases' sessions and graphs, the profiler
    # saw none of B3's kernels on the card (an empty record, not a failure)
    with device_profile() as prof:
        for x in xs:
            fv_kernel.fisher_vector_stats(x, means, variances, weights, thresh)
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        name = re.search(r"(fv_\w+)", e.key)
        if name and e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            by[name.group(1)] = by.get(name.group(1), 0.0) + e.device_time_total / 1e3
    return by


def hmma_counts(lib_path):
    """HMMA instructions in each kernel of a built library, from
    cuobjdump's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        head = re.search(r"Function : .*?([a-z]+_[a-z_]*?kernel)(?:ILi|E)", ln)
        if head:
            fn = head.group(1)
            counts.setdefault(fn, 0)
        elif fn and "HMMA" in ln:
            counts[fn] += 1
    return counts


def max_abs_err(got, want, rtol, atol, what):
    got, want = (torch.as_tensor(t) for t in (got, want))
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol {rtol} / atol {atol}; max abs err {float(err.max())}"
        )
    return float(err.max())


def sift_inputs(imgs_u8, dev):
    """The (mag, orient) and sampling matrices the SIFT path gives the
    kernel at each scale, from raw images."""
    x = (imgs_u8.to(torch.float32) / 255.0) @ torch.tensor(
        (0.2989, 0.5870, 0.1140), device=dev
    )
    out = []
    for scale in range(CONF["sift_scales"]):
        bin_size = CONF["sift_bin"] + 2 * scale
        step = CONF["sift_step"] + scale * CONF["sift_scale_step"]
        bnd = (1 + 2 * CONF["sift_scales"]) - 3 * scale
        sm = sift._sep_conv2d(x, sift._gaussian_kernel(bin_size / sift.MAGNIF))
        gy, gx = torch.gradient(sm, dim=(1, 2))
        mag = torch.sqrt(gx * gx + gy * gy).contiguous()
        ang = torch.remainder(torch.atan2(gy, gx), 2.0 * np.pi)
        t = (ang / (2.0 * np.pi) * 8).contiguous()
        nf = (IMG - 1 - bnd - 3 * bin_size) // step + 1
        a = sift._sampling_matrix(IMG, nf, bin_size, step, bnd)
        ayt, ax = torch.as_tensor(a.T.copy(), device=dev), torch.as_tensor(a, device=dev)
        out.append((mag, t, ayt, ax, kernels.operator_bands(ayt, ax)))
    return out


def lcs_extractor():
    return lcs.LCSExtractor(CONF["lcs_stride"], CONF["lcs_border"], CONF["lcs_patch"])


def lcs_inputs(imgs_u8, dev):
    """The planes, operators and cached bands the LCS path gives the
    kernel, from raw images."""
    img = imgs_u8.to(torch.float32)
    at, bm, bands, *_ = lcs_extractor().operators(IMG, IMG, dev)
    z = torch.cat([img, img * img], dim=-1).permute(0, 3, 1, 2).contiguous()
    return z, at, bm, bands


def fv_library(x, means, variances, weights, thresh):
    """The FV statistics as a chain of PyTorch calls (bmm, softmax):
    the yardstick, never used by the port."""
    inv_var, proj, const = fv_kernel.gmm_terms(means, variances, weights)
    xt = x.transpose(1, 2)
    lhs = torch.cat([xt * xt, xt], dim=-1)
    rhs = torch.cat([-0.5 * inv_var, proj], dim=0)
    q = torch.softmax(torch.matmul(lhs, rhs) + const, dim=-1)
    q = q * (q > thresh)
    q = q / q.sum(-1, keepdim=True)
    s = torch.matmul(torch.cat([x, x * x], dim=1), q) / x.shape[2]
    return q.sum(1) / x.shape[2], s


def check_ragged(dev, gen):
    """Each kernel against its plain version at shapes that are no
    multiple of any tile (edges of M, N, H, W, m and k < 32), and on the
    paths the serving shapes do not take: W over one column chunk of B1's
    and B2's stage 1, W not a multiple of 4 (B2's 4-byte staging), a tile
    of all-zero rows and a group of all-zero columns, k over 32 in B3."""
    def r(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    for h, w, m, n in ((50, 70, 37, 45), (40, 300, 21, 37)):
        mag, t = r(3, h, w).abs(), r(3, h, w).abs() * 3
        ayt, ax = r(m, h), r(w, n)
        max_abs_err(kernels.sift_bin_sample(mag, t, ayt, ax),
                    kernels.sift_bin_sample_plain(mag, t, ayt, ax),
                    RTOL_SANDWICH, ATOL_SANDWICH, f"sift_bin_sample ragged W={w}")
    # real SIFT operators, cropped so the bands straddle the kernel's row
    # and column tiles, with 10 all-zero rows (a whole tile once sorted)
    # and 8 all-zero columns (a whole column group)
    mag, t = r(3, 50, 70).abs(), r(3, 50, 70).abs() * 3
    ayt = sift._sampling_matrix(50, 10, 4, 3, 9).T[3:38].copy()
    ax = sift._sampling_matrix(70, 17, 4, 3, 9)[:, 2:47].copy()
    ayt[5:15], ax[:, 8:16] = 0.0, 0.0
    ayt, ax = torch.as_tensor(ayt, device=dev), torch.as_tensor(ax, device=dev)
    bands = kernels.operator_bands(ayt, ax)
    want = kernels.sift_bin_sample_plain(mag, t, ayt, ax)
    for b in (bands, None):
        max_abs_err(kernels.sift_bin_sample(mag, t, ayt, ax, b), want,
                    RTOL_SANDWICH, ATOL_SANDWICH, "sift_bin_sample ragged banded")
    planes, at, bm = r(2, 5, 131, 133), r(67, 131), r(133, 129)
    max_abs_err(kernels.plane_sandwich(planes, at, bm),
                kernels.plane_sandwich_plain(planes, at, bm),
                RTOL_SANDWICH, ATOL_SANDWICH, "plane_sandwich ragged")
    # real LCS operators, cropped so the bands straddle the kernel's 16-row
    # tiles and 32-column warp groups, with 20 all-zero rows of at (a whole
    # tile once sorted) and 8 all-zero columns of b; W = 131 takes the
    # 4-byte staging, W = 300 the 16-byte one over two column chunks
    for h, w, rows, cols in ((133, 131, (3, 90), (2, 95)), (70, 300, (1, 38), (5, 200))):
        at, bm, *_ = lcs_extractor().operators(h, w, "cpu")
        at = at[rows[0]:rows[1]].clone()
        bm = bm[:, cols[0]:cols[1]].clone()
        at[5:25], bm[:, 8:16] = 0.0, 0.0
        at, bm = at.to(dev), bm.to(dev)
        planes = r(2, 5, h, w)
        bands = kernels.operator_bands(at, bm)
        want = kernels.plane_sandwich_plain(planes, at, bm)
        for b in (bands, None):
            max_abs_err(kernels.plane_sandwich(planes, at, bm, b), want,
                        RTOL_SANDWICH, ATOL_SANDWICH, f"plane_sandwich ragged banded W={w}")
    for d, k, m in ((8, 7, 1500), (8, 40, 500)):
        x, means = r(2, d, m), r(d, k)
        variances, weights = 0.5 + r(d, k).abs(), torch.full((k,), 1 / k, device=dev)
        for g, w in zip(fv_kernel.fisher_vector_stats(x, means, variances, weights),
                        fv_kernel.fisher_vector_stats_plain(x, means, variances, weights)):
            max_abs_err(g, w, RTOL_FV, ATOL_FV, f"fisher_vector_stats ragged k={k}")


def _wide_row(name, got, want, rtol, atol, fn, plain, library, flops, nbytes, shapes, extra=None):
    """One wide-shape case: the kernel's error against its plain version,
    the kernel, the plain version and the one-call PyTorch yardstick
    timed, and the bound (and ``extra`` keys, such as B3's tensor-core
    bound and copy width, into the row and its line)."""
    err = max(max_abs_err(g, w, rtol, atol, f"{name} [{shapes}]") for g, w in zip(got, want))
    b_ms, b_by = bound(flops, nbytes)
    ms = time_ms(fn, calls=3, rounds=3, warmup=1)
    row = dict(name=name, shapes=shapes, max_abs_err=err, ms=ms,
               plain_ms=time_ms(plain, calls=1, rounds=1, warmup=1),
               library_ms=time_ms(library, calls=1, rounds=1, warmup=1),
               bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms, **(extra or {}))
    more = "".join(f", {k} {v:.4f}" if isinstance(v, float) else f", {k} {v}"
                   for k, v in (extra or {}).items())
    log(f"  {name} [{shapes}]: {ms:.3f} ms (plain {row['plain_ms']:.3f}, library "
        f"{row['library_ms']:.3f}, bound {b_ms:.4f} by {b_by}, share {b_ms / ms:.3f}{more}), "
        f"max abs err {err:.3g}")
    return row


def _fv_extra(xs, d, k):
    """B3 rows' tensor-core bound in ms (the larger of 3 x the four
    products' FLOPs at the TF32 rate, for 3xTF32, and the bytes at the
    memory rate) and cp.async copy width (16, 8 or 4 bytes; the tiled
    path's, by m and x's alignment)."""
    nbytes = sum(4 * (x.numel() + 2 * d * k + k + x.shape[0] * (1 + 2 * d) * k) for x in xs)
    tf32_flops = sum(3 * x.shape[0] * x.shape[2] * 8 * d * k for x in xs)
    return {"bound_tc_ms": max(tf32_flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            "copy_bytes": [fv_kernel.copy_bytes(x) for x in xs]}


def sift_library(mag, t, ayt, ax):
    """B1's yardstick: the orientation planes, then one einsum."""
    return torch.einsum("mh,bohw,wn->bomn", ayt, kernels.orientation_planes(mag, t), ax)


def lcs_library(z, at, bm):
    """B2's yardstick: one einsum."""
    return torch.einsum("mh,bphw,wn->bpmn", at, z, bm)


def check_wide(dev, gen):
    """Phase 3, the shapes past the old limits: B1 at W = 1,024 and 2,048
    with dense operators (every window wider than a chunk) and with one
    scale's real SIFT operators of a 1,536 x 2,048 image and of a tall
    2,048 x 300 one; B2 at W = 2,048 dense and with real LCS operators,
    with and without their bands; B3 at (d, k) = (64, 256), (80, 256) and
    (129, 257) at m = 1, 1,500 and 13,165, and (64, 1,100) at m = 1,500;
    TopKClassifier on tied rows
    against a stable sort on the host, and its cost beside torch.topk.
    Each case held against its plain version on the card and timed."""
    def r(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def u(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    # Dense operators here are non-negative, as the extractors' sampling
    # operators are: sums of thousands of signed terms cancel to entries
    # near zero, where two float32 summation orders differ by more than
    # atol (1e-3 at W = 2,048), which says nothing of the kernel
    rows = []
    for h, w, m, n in ((64, 1024, 37, 45), (48, 2048, 21, 70)):
        mag, t = u(2, h, w), u(2, h, w) * 8
        ayt, ax = u(m, h), u(w, n)
        rows.append(_wide_row(
            "sift_bin_sample dense", [kernels.sift_bin_sample(mag, t, ayt, ax)],
            [kernels.sift_bin_sample_plain(mag, t, ayt, ax)], RTOL_SANDWICH, ATOL_SANDWICH,
            lambda: kernels.sift_bin_sample(mag, t, ayt, ax),
            lambda: kernels.sift_bin_sample_plain(mag, t, ayt, ax),
            lambda: sift_library(mag, t, ayt, ax),
            2 * 2 * 8 * m * w * (h + n), 4 * (4 * h * w + ayt.numel() + ax.numel() + 16 * m * n),
            f"B=2 H={h} W={w} M={m} N={n}"))
    for h, w in ((1536, 2048), (2048, 300)):
        mag, t = r(1, h, w).abs(), torch.rand(1, h, w, device=dev, generator=gen) * 8
        _, ayt, ax, bands = sift.scale_operators(h, w, 3, 4, 4, 1, dev)[0]
        want = kernels.sift_bin_sample_plain(mag, t, ayt, ax)
        for b in (bands, None):
            got = kernels.sift_bin_sample(mag, t, ayt, ax, b)
            max_abs_err(got, want, RTOL_SANDWICH, ATOL_SANDWICH,
                        f"sift_bin_sample real H={h} W={w} bands={b is not None}")
            del got
        M, N = ayt.shape[0], ax.shape[1]
        rows.append(_wide_row(
            "sift_bin_sample real", [kernels.sift_bin_sample(mag, t, ayt, ax, bands)], [want],
            RTOL_SANDWICH, ATOL_SANDWICH,
            lambda: kernels.sift_bin_sample(mag, t, ayt, ax, bands),
            lambda: kernels.sift_bin_sample_plain(mag, t, ayt, ax),
            lambda: sift_library(mag, t, ayt, ax),
            band_flops(bands[0], bands[1], w, M, 8),
            4 * (2 * h * w + ayt.numel() + ax.numel() + 8 * M * N),
            f"B=1 H={h} W={w} M={M} N={N}, scale 0"))
        del want
    planes, at, bm = u(1, 3, 40, 2048), u(33, 40), u(2048, 50)
    rows.append(_wide_row(
        "plane_sandwich dense", [kernels.plane_sandwich(planes, at, bm)],
        [kernels.plane_sandwich_plain(planes, at, bm)], RTOL_SANDWICH, ATOL_SANDWICH,
        lambda: kernels.plane_sandwich(planes, at, bm),
        lambda: kernels.plane_sandwich_plain(planes, at, bm),
        lambda: lcs_library(planes, at, bm),
        2 * 3 * 33 * 2048 * (40 + 50), 4 * (planes.numel() + at.numel() + bm.numel() + 3 * 33 * 50),
        "B=1 P=3 H=40 W=2048 M=33 N=50"))
    h, w = 256, 2048
    at, bm, bands, *_ = lcs_extractor().operators(h, w, dev)
    imgs = torch.randint(0, 256, (2, h, w, 3), device=dev, generator=gen).to(torch.float32)
    z = torch.cat([imgs, imgs * imgs], dim=-1).permute(0, 3, 1, 2).contiguous()
    want = kernels.plane_sandwich_plain(z, at, bm)
    for b in (bands, None):
        max_abs_err(kernels.plane_sandwich(z, at, bm, b), want, RTOL_SANDWICH, ATOL_SANDWICH,
                    f"plane_sandwich real W={w} bands={b is not None}")
    M, N = at.shape[0], bm.shape[1]
    rows.append(_wide_row(
        "plane_sandwich real", [kernels.plane_sandwich(z, at, bm, bands)], [want],
        RTOL_SANDWICH, ATOL_SANDWICH, lambda: kernels.plane_sandwich(z, at, bm, bands),
        lambda: kernels.plane_sandwich_plain(z, at, bm), lambda: lcs_library(z, at, bm),
        band_flops(bands[0], bands[1], w, M, 12),
        4 * (z.numel() + at.numel() + bm.numel() + 12 * M * N), f"B=2 P=6 H={h} W={w} M={M} N={N}"))
    del z, want
    # B3 past 64: (d, k) of the flagship at vocabulary 256, VOC, a shape
    # past every tile, and k past the old bound of 1,024
    for d, k, ms_ in ((64, 256, (1, 1500, 13165)), (80, 256, (1, 1500, 13165)),
                      (129, 257, (1, 1500, 13165)), (64, 1100, (1500,))):
        means = r(d, k)
        variances, weights = 0.5 + r(d, k).abs(), torch.full((k,), 1 / k, device=dev)
        for m in ms_:
            x = r(2, d, m)
            args = (x, means, variances, weights)
            rows.append(_wide_row(
                "fisher_vector_stats", fv_kernel.fisher_vector_stats(*args),
                fv_kernel.fisher_vector_stats_plain(*args), RTOL_FV, ATOL_FV,
                lambda: fv_kernel.fisher_vector_stats(*args),
                lambda: fv_kernel.fisher_vector_stats_plain(*args),
                lambda: fv_library(*args, 1e-4),
                fv_flops(2, m, d, k), 4 * (x.numel() + 2 * d * k + k + 2 * (1 + 2 * d) * k),
                f"B=2 d={d} k={k} m={m}", _fv_extra([x], d, k)))
    # B3 at phase 8's streaming shapes: both branches' descriptor counts of
    # a bucket of 64 images of 256², at the paper's vocabulary
    d, k = CONF["desc_dim"], 256
    means = r(d, k)
    variances, weights = 0.5 + r(d, k).abs(), torch.full((k,), 1 / k, device=dev)
    xs = [r(B, d, m) for m in (13165, 3136)]
    got = [t for x in xs for t in fv_kernel.fisher_vector_stats(x, means, variances, weights)]
    want = [t for x in xs for t in fv_kernel.fisher_vector_stats_plain(x, means, variances, weights)]
    rows.append(_wide_row(
        "fisher_vector_stats", got, want, RTOL_FV, ATOL_FV,
        lambda: [fv_kernel.fisher_vector_stats(x, means, variances, weights) for x in xs],
        lambda: [fv_kernel.fisher_vector_stats_plain(x, means, variances, weights) for x in xs],
        lambda: [fv_library(x, means, variances, weights, 1e-4) for x in xs],
        sum(fv_flops(B, x.shape[2], d, k) for x in xs),
        sum(4 * (x.numel() + 2 * d * k + k + B * (1 + 2 * d) * k) for x in xs),
        f"B={B} d={d} k={k} m in (13165, 3136)", _fv_extra(xs, d, k)))
    del got, want
    by_kernel = {}
    if dev.type == "cuda":  # device time by kernel: the passes and their helpers
        by_kernel["phase8_pair"] = fv_by_kernel(xs, means, variances, weights)
        del xs
        # and at the VOC fit chunk's shape (phase 9 times it with the fitted GMM)
        means = r(80, 256)
        variances, weights = 0.5 + r(80, 256).abs(), torch.full((256,), 1 / 256, device=dev)
        xs = [r(B, 80, 73866)]
        by_kernel["voc_chunk"] = fv_by_kernel(xs, means, variances, weights)
        del xs
        log(f"  fisher_vector_stats by kernel (ms): phase 8's pair [B={B} d={d} k={k} m in "
            f"(13165, 3136)] {by_kernel['phase8_pair']}; the VOC chunk's shape [B={B} d=80 "
            f"k=256 m=73866, random data] {by_kernel['voc_chunk']}")
    else:
        del xs
    # ties: all-zero rows and integer scores in 0..3, against a stable sort
    # of the negated scores on the host (ties to the lower index)
    top = TopKClassifier(TOP_K)
    for scores in (torch.zeros(64, CLASSES, device=dev),
                   torch.randint(0, 4, (64, CLASSES), device=dev, generator=gen).to(torch.float32)):
        got = top.apply_batch(Dataset.from_array(scores)).array().cpu().numpy()
        want = np.argsort(-scores.cpu().numpy(), axis=1, kind="stable")[:, :TOP_K]
        assert np.array_equal(got, want), (got[:2], want[:2])
    scores = torch.randn(64, CLASSES, device=dev, generator=gen)
    topk = {"sort_ms": time_ms(lambda: top.apply(scores)),
            "torch_topk_ms": time_ms(lambda: torch.topk(scores, TOP_K, dim=-1))}
    log(f"  TopKClassifier on tied rows equals a stable host sort; at 64 x {CLASSES}: stable sort "
        f"{topk['sort_ms']:.4f} ms, torch.topk {topk['torch_topk_ms']:.4f} ms")
    return {"cases": rows, "top_k": topk, "fv_by_kernel_ms": by_kernel}


def check_kernels(dev, gen):
    """Phase 3: each kernel against its plain version at B = 64."""
    imgs = torch.randint(0, 256, (B, IMG, IMG, 3), dtype=torch.uint8,
                         device=dev, generator=gen)
    rows = []

    # B1 — all four SIFT scales, as one dispatch runs them
    scales = sift_inputs(imgs, dev)
    err = 0.0
    for mag, t, ayt, ax, bands in scales:
        got = kernels.sift_bin_sample(mag, t, ayt, ax, bands)
        want = kernels.sift_bin_sample_plain(mag, t, ayt, ax)
        err = max(err, max_abs_err(got, want, RTOL_SANDWICH, ATOL_SANDWICH,
                                   f"sift_bin_sample M={ayt.shape[0]}"))
    flops, nbytes = (sum(w) for w in zip(*(kernels.sift_bin_sample_work(mag, ayt, ax, bands)
                                           for mag, _, ayt, ax, bands in scales)))
    dense_flops = sum(2 * B * 8 * ayt.shape[0] * IMG * (IMG + ax.shape[1])
                      for _, _, ayt, ax, _ in scales)
    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name="sift_bin_sample", route="cuda",
        source="keystone_tpu_torch/csrc/sift_bin.cu",
        replaces="keystone_tpu/ops/images/pallas_kernels.py:76",
        max_abs_err=err,
        ms=time_ms(lambda: [kernels.sift_bin_sample(*s) for s in scales]),
        plain_ms=time_ms(lambda: [kernels.sift_bin_sample_plain(*s[:4]) for s in scales]),
        library_ms=time_ms(lambda: [sift_library(*s[:4]) for s in scales]),
        bound_ms=b_ms, bound_by=b_by, flops=flops, dense_flops=dense_flops,
        bytes=nbytes,
        shapes=f"B={B} H=W={IMG} M=N in {[s[2].shape[0] for s in scales]}",
    ))

    # B2 — LCS, P = 6, with the bands the extractor caches
    z, at, bm, bands = lcs_inputs(imgs, dev)
    got = kernels.plane_sandwich(z, at, bm, bands)
    want = kernels.plane_sandwich_plain(z, at, bm)
    err = max_abs_err(got, want, RTOL_SANDWICH, ATOL_SANDWICH, "plane_sandwich")
    del got, want
    M = at.shape[0]
    flops, nbytes = kernels.plane_sandwich_work(z, at, bm, bands)
    dense_flops = 2 * B * 6 * M * IMG * (IMG + M)
    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name="plane_sandwich", route="cuda",
        source="keystone_tpu_torch/csrc/sandwich.cu",
        replaces="keystone_tpu/ops/images/pallas_kernels.py:129",
        max_abs_err=err,
        ms=time_ms(lambda: kernels.plane_sandwich(z, at, bm, bands)),
        plain_ms=time_ms(lambda: kernels.plane_sandwich_plain(z, at, bm)),
        library_ms=time_ms(lambda: lcs_library(z, at, bm)),
        bound_ms=b_ms, bound_by=b_by, flops=flops, dense_flops=dense_flops,
        bytes=nbytes,
        shapes=f"B={B} P=6 H=W={IMG} M=N={M}",
    ))
    del z

    # B3 — both branches' descriptor counts, d = 64, k = 32
    d, k = CONF["desc_dim"], CONF["vocab"]
    means = torch.randn(d, k, device=dev, generator=gen)
    variances = torch.ones(d, k, device=dev)
    weights = torch.ones(k, device=dev) / k
    xs = [torch.randn(B, d, m, device=dev, generator=gen) for m in (13165, 3136)]
    err = 0.0
    for x in xs:
        for g, w, name in zip(
            fv_kernel.fisher_vector_stats(x, means, variances, weights),
            fv_kernel.fisher_vector_stats_plain(x, means, variances, weights),
            ("s0", "s1", "s2"),
        ):
            err = max(err, max_abs_err(g, w, RTOL_FV, ATOL_FV,
                                       f"fisher_vector_stats m={x.shape[2]} {name}"))
    flops, nbytes = (sum(w) for w in zip(*(fv_kernel.fisher_vector_stats_work(x, k)[:2]
                                           for x in xs)))
    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name="fisher_vector_stats", route="cuda", **_fv_extra(xs, d, k),
        source="keystone_tpu_torch/csrc/fv_stats.cu",
        replaces="keystone_tpu/ops/images/fv_pallas.py:80",
        max_abs_err=err,
        ms=time_ms(lambda: [fv_kernel.fisher_vector_stats(x, means, variances, weights) for x in xs]),
        plain_ms=time_ms(lambda: [fv_kernel.fisher_vector_stats_plain(x, means, variances, weights) for x in xs]),
        library_ms=time_ms(lambda: [fv_library(x, means, variances, weights, 1e-4) for x in xs]),
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        shapes=f"B={B} d={d} k={k} m in (13165, 3136)",
    ))
    return rows


def serve(dev, smi):
    """Phase 4 and 5: the flagship through buckets (8, 64), one CUDA graph
    per bucket. Returns the record and the chain and head, which phase 7
    serves again."""
    t0 = time.perf_counter()
    feat, feat_dim = build_flagship_featurize_pipeline(device=dev, **CONF)
    assert feat_dim == 8192, feat_dim
    rng = np.random.default_rng(11)
    W = (rng.standard_normal((feat_dim, CLASSES)) / np.sqrt(feat_dim)).astype(np.float32)
    icpt = (rng.standard_normal(CLASSES) * 0.01).astype(np.float32)
    model = model_head(W, icpt, TOP_K, dev)
    engine = model.compiled(buckets=BUCKETS, featurize=feat, device=dev)
    capture_s = engine.warmup(example=np.zeros((IMG, IMG, 3), np.uint8))
    log(f"built the serving pipeline and captured buckets {capture_s} (s) in "
        f"{time.perf_counter() - t0:.3f} s")
    cost = cost_models(engine)
    log(f"phase 4's cost model per bucket (the warm passes' count): {cost} on {smi}")
    assert sorted(cost) == list(BUCKETS), cost
    for c in cost.values():
        assert set(c["kernel_flops"]) == set(_cuda.LAUNCHES) and c["flops"] > 0, c

    reqs = [rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8) for n in REQUESTS]
    _cuda.reset_launches()
    outs = [engine.apply(r, sync=True) for r in reqs]
    launches = dict(_cuda.LAUNCHES)
    dispatches = sum(-(-n // engine.max_bucket) for n in REQUESTS)
    want = {"sift_bin_sample": 4 * dispatches, "plane_sandwich": dispatches,
            "fisher_vector_stats": 2 * dispatches}
    log(f"launches over {dispatches} dispatches: {launches} (expected {want})")
    assert launches == want, (launches, want)
    assert engine.metrics.compile_count == len(BUCKETS), engine.metrics.summary()
    for o, n in zip(outs, REQUESTS):
        assert tuple(o.shape) == (n, TOP_K) and o.device.type == "cuda", o.shape

    # the first 8 images against the port on the CPU (plain versions)
    t1 = time.perf_counter()
    feat_cpu, _ = build_flagship_featurize_pipeline(device="cpu", **CONF)
    model_cpu = model_head(W, icpt, TOP_K, "cpu")
    raw8 = torch.as_tensor(reqs[1])
    f_cpu = feat_cpu._batch_run(raw8)
    top_cpu = model_cpu._batch_run(f_cpu)
    log(f"CPU reference for 8 images in {time.perf_counter() - t1:.3f} s")
    f_gpu = feat._batch_run(raw8.to(dev)).cpu()
    assert torch.isfinite(f_gpu).all()
    # SIFT descriptors, card vs CPU: the repo's golden bar (±1 of the
    # ×512-quantized values on >= 99.5 % of entries)
    ext = sift.SIFTExtractor(step=3, bin=4, num_scales=4, scale_step=1)
    gray = (raw8.to(torch.float32) / 255.0) @ torch.tensor((0.2989, 0.5870, 0.1140))
    s_cpu = ext.extract(gray)
    s_gpu = ext.extract(gray.to(dev)).cpu()
    sift_diff = (s_cpu - s_gpu).abs()
    sift_rec = {
        "entries": sift_diff.numel(),
        "differing": int((sift_diff > 0).sum()),
        "within_1_share": float((sift_diff <= 1).float().mean()),
    }
    log(f"SIFT card vs CPU: {sift_rec}")
    assert sift_rec["within_1_share"] >= 0.995, sift_rec
    feat_err = float((f_gpu - f_cpu).abs().max())
    feat_ok = bool(torch.allclose(f_gpu, f_cpu, rtol=RTOL_FEAT, atol=ATOL_FEAT))
    top_equal = bool(torch.equal(outs[1].cpu(), top_cpu))
    log(f"features card vs CPU: max abs err {feat_err} (allclose rtol "
        f"{RTOL_FEAT} atol {ATOL_FEAT}: {feat_ok}); top-5 equal: {top_equal}")
    assert feat_ok, feat_err
    assert top_equal

    rec = {
        "launches": launches, "dispatches": dispatches, "sift": sift_rec,
        "feature_max_abs_err": feat_err, "top5_equal": top_equal,
        "capture_s": capture_s, "graphs": engine.graph_report(), "cost_model": cost,
    }
    rec.update(throughput_and_profile(engine, rng, smi))
    rec["device_truth"] = device_truth(engine, cost, rec["replay_ms"], smi)
    return rec, feat, model


def cost_models(engine):
    """The engine's cost model per bucket: flops, bytes accessed,
    transcendentals, and the FLOPs each kernel reported in it."""
    return {b: {"flops": m["flops"], "bytes_accessed": m["bytes_accessed"],
                "transcendentals": m["transcendentals"],
                "kernel_flops": {k: v["flops"] for k, v in engine.kernel_costs[b].items()}}
            for b, m in sorted(engine.metrics.cost_models.items())}


def device_truth(engine, cost, replay_ms, smi):
    """Phase 5's MFU and roofline: the engine's own ``/metrics`` series
    (the rolling ``keystone_serving_mfu`` and each bucket's
    ``keystone_device_roofline_bound``) must be present, and each
    bucket's replay (CUDA events) gives its FLOPs over the replay time
    over the card's peak."""
    from keystone_tpu_torch.observability import device as device_obs
    from keystone_tpu_torch.observability import prometheus
    from keystone_tpu_torch.observability.registry import get_global_registry

    text = prometheus.render(get_global_registry().collect())
    lines = [ln for ln in text.splitlines()
             if not ln.startswith("#") and f'engine="{engine.name}"' in ln]
    mfu_lines = [ln for ln in lines if ln.startswith("keystone_serving_mfu{")]
    roofline = {}
    for name, labels, v in prometheus.parse_samples("\n".join(lines)):
        if name == "keystone_device_roofline_bound" and v == 1.0:
            roofline[int(labels["bucket"])] = labels["bound"]
    peak_flops, peak_bytes = device_obs.peaks_of(engine.device)
    replay_mfu = {b: cost[b]["flops"] / (replay_ms[b] / 1e3) / peak_flops for b in cost}
    rec = {"mfu_gauge": engine.metrics.mfu(), "mfu_lines": mfu_lines, "roofline": roofline,
           "replay_mfu": replay_mfu, "peaks": [peak_flops, peak_bytes],
           "intensity": {b: c["flops"] / c["bytes_accessed"] for b, c in cost.items()}}
    log(f"phase 5 device truth: /metrics {mfu_lines}, roofline {roofline}; a replay's MFU "
        f"(its FLOPs over the CUDA-event replay time over {peak_flops:.3g} FLOP/s) {replay_mfu}; "
        f"FLOPs per byte {rec['intensity']} on {smi}")
    assert mfu_lines and sorted(roofline) == list(BUCKETS), (mfu_lines, roofline)
    return rec


def throughput_and_profile(engine, rng, smi, img=IMG):
    """Phase 5 (and phase 7's last step): examples/sec per bucket, a uint8
    host batch in and top-5 on the card, median of 5 after one warm
    dispatch; then, on the card, one profiled bucket-64 dispatch, by
    device activity (kernels and copies). The rest of the dispatch's wall
    time the device sat idle."""
    throughput = {}
    for b in BUCKETS:
        batch = rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8)
        engine.apply(batch, sync=True)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            engine.apply(batch, sync=True)
            times.append(time.perf_counter() - t)
        med = statistics.median(times)
        throughput[b] = {"median_s": med, "ex_per_s": b / med, "runs_s": times}
        log(f"bucket {b}: {b / med:.1f} ex/s (median of 5, {med * 1e3:.2f} ms "
            f"per dispatch) on {smi}")
    if engine.device.type != "cuda":
        return {"throughput": throughput}

    batch = rng.integers(0, 256, (64, img, img, 3), dtype=np.uint8)
    from torch.autograd import DeviceType

    engine.apply(batch, sync=True)
    with device_profile() as prof:
        t = time.perf_counter()
        engine.apply(batch, sync=True)
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    device_ms = sum(e.device_time_total for e in events) / 1e3
    assert device_ms > 0, "the profiler saw no device time"
    # the busy time without copies is the one the kernels move
    copy_ms = sum(e.device_time_total for e in events if e.key.startswith("Memcpy")) / 1e3
    h2d_ms = sum(e.device_time_total for e in events if "HtoD" in e.key) / 1e3
    top = [(e.key[:90], e.device_time_total / 1e3, e.count) for e in events[:15]]
    ours = [(e.key[:90], e.device_time_total / 1e3, e.count) for e in events
            if any(k in e.key for k in ("sift_bin_kernel", "sandwich_kernel", "fv_"))]
    # the profiler does not show the copies on the engine's copy stream:
    # time the pinned upload of a bucket-64 batch there by CUDA events
    # around 10 copies in a row, and each graph's replay on the compute
    # stream the same way
    host = engine.alloc_host(batch, 64)
    engine.host_stage(batch, 64, 64, host)
    with torch.cuda.stream(engine._copy_stream):
        pinned_ms = time_ms(lambda: host.to(engine.device, non_blocking=True))
    replay_ms = {}
    with torch.cuda.stream(engine._compute_stream):
        for (bucket, _), g in engine._graphs.items():
            replay_ms[bucket] = time_ms(g.graph.replay)
    log(f"profile of one bucket-64 dispatch: wall {wall_ms:.3f} ms, device "
        f"busy {device_ms:.3f} ms ({device_ms - copy_ms:.3f} without copies; "
        f"host-to-device copies seen {h2d_ms:.3f}), idle share "
        f"{1 - device_ms / wall_ms:.3f}; the pinned upload of {host.nbytes} bytes "
        f"{pinned_ms:.3f} ms and a replay {replay_ms} ms by CUDA events, on {smi}")
    for key, ms, n in top:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key}")
    log("the port's kernels in that dispatch:")
    for key, ms, n in ours:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key}")
    return {
        "throughput": throughput, "profile_wall_ms": wall_ms,
        "profile_device_ms": device_ms, "profile_copy_ms": copy_ms,
        "profile_h2d_ms": h2d_ms, "profile_idle_share": 1 - device_ms / wall_ms,
        "pinned_upload_ms": pinned_ms, "replay_ms": replay_ms,
        "profile_top": top, "profile_kernels": ours,
    }


def closed_loop(engine, depth, images, max_delay_ms, seconds):
    """``STREAM_THREADS`` client threads, each keeping its share of
    ``STREAM_IN_FLIGHT`` single-image requests in flight through one
    ``MicroBatcher`` for ``seconds``. The engine records into a fresh
    ``ServingMetrics`` (with room for every request's latency) for this
    run. Returns its record."""
    engine.metrics = metrics = ServingMetrics(latency_window=1 << 18)
    mb = MicroBatcher(engine, max_delay_ms=max_delay_ms, pipeline_depth=depth)
    per_thread = STREAM_IN_FLIGHT // STREAM_THREADS
    done = [0] * STREAM_THREADS
    errors = []

    def client(tid):
        try:
            q = deque(mb.submit(images[(tid + i * STREAM_THREADS) % len(images)])
                      for i in range(per_thread))
            i = per_thread
            while q:
                row = q.popleft().result(timeout=120)
                assert row.shape == (TOP_K,)
                done[tid] += 1
                if time.perf_counter() < stop:
                    q.append(mb.submit(images[(tid + i * STREAM_THREADS) % len(images)]))
                    i += 1
        except Exception as e:  # reported below, and the phase fails
            errors.append(repr(e))

    try:
        t0 = time.perf_counter()
        stop = t0 + seconds
        threads = [threading.Thread(target=client, args=(t,)) for t in range(STREAM_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(seconds + 240)
        elapsed = time.perf_counter() - t0
        assert not any(t.is_alive() for t in threads), "a client thread hung"
    finally:
        mb.close()
    assert not errors, errors
    summ = metrics.summary()
    rec = {
        "pipeline_depth": depth, "in_flight": STREAM_THREADS * per_thread,
        "max_delay_ms": max_delay_ms,
        "seconds": elapsed, "requests": sum(done), "req_per_s": sum(done) / elapsed,
        "request_p50_ms": summ["request_p50_ms"], "request_p99_ms": summ["request_p99_ms"],
        "mean_coalesced": metrics.examples.total / metrics.dispatches.total,
        "dispatches_per_bucket": summ["dispatches_per_bucket"],
        "dispatch_p50_ms": summ["dispatch_p50_ms"],
        "stages_ms": summ.get("pipeline", {}).get("stages"),
        "bottleneck": metrics.bottleneck(), "overlap_efficiency": metrics.overlap_efficiency(),
        "staging_bytes": metrics.staging_bytes,
    }
    return rec


def serve_stream(dev, smi, feat, model, img=IMG, seconds=STREAM_S):
    """Phase 7: phase 4's chain and head under a request stream. To
    rehearse it on the CPU at a small size (no graphs there, so no
    captures, and no profile): ``serve_stream(torch.device("cpu"), "cpu",
    feat, model, img=48, seconds=1)`` with a 48² chain and its head."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    example = np.zeros((img, img, 3), np.uint8)
    engine = model.compiled(buckets=BUCKETS, featurize=feat, device=dev, name="phase7")
    on_card = dev.type == "cuda"
    reserved = torch.cuda.memory_reserved(dev) if on_card else 0
    capture_s = engine.warmup(example=example)
    metrics = engine.metrics
    captures = len(BUCKETS) if on_card else 0
    assert metrics.compile_count == captures, metrics.summary()
    graphs = engine.graph_report()
    for g in graphs:
        log(f"bucket {g['bucket']}: captured in {capture_s[g['bucket']]:.3f} s (warm pass, "
            f"capture and one replay), graph pool {g['pool_bytes']} bytes, launches per "
            f"replay {g['launches']} on {smi}")
    rec = {"capture_s": capture_s, "graphs": graphs,
           "reserved_by_warmup": (torch.cuda.memory_reserved(dev) if on_card else 0) - reserved}

    # -- graph against eager -------------------------------------------
    features = feat.compiled(buckets=BUCKETS, device=dev, name="phase7-features")
    features.warmup(example=example)
    rec["graph_vs_eager"] = {}
    for b in (64, 8):
        raw = rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8)
        x = torch.as_tensor(raw).to(dev)
        top_equal = bool(torch.equal(engine.apply(raw, sync=True), engine._run_bucket(x)))
        err = max_abs_err(features.apply(raw, sync=True), features._run_bucket(x),
                          RTOL_FEAT, ATOL_FEAT, f"bucket {b} features, graph vs eager")
        rec["graph_vs_eager"][b] = {"top5_equal": top_equal, "feature_max_abs_err": err}
        log(f"bucket {b}, graph vs eager: top-5 equal {top_equal}, features max abs err {err}")
        assert top_equal
    del features
    raw64 = rng.integers(0, 256, (64, img, img, 3), dtype=np.uint8)
    _cuda.reset_launches()
    n_replays = 3
    for _ in range(n_replays):
        engine.apply(raw64, sync=True)
    k = n_replays if on_card else 0
    want = {"sift_bin_sample": 4 * k, "plane_sandwich": k, "fisher_vector_stats": 2 * k}
    log(f"launches over {n_replays} replays: {dict(_cuda.LAUNCHES)} (expected {want})")
    assert _cuda.LAUNCHES == want, (_cuda.LAUNCHES, want)

    # -- deterministic windows: bursts of exactly 64 -------------------
    bursts = rng.integers(0, 256, (3, 64, img, img, 3), dtype=np.uint8)
    direct = np.concatenate([engine.apply(b, sync=True).cpu().numpy() for b in bursts])
    rows = {}
    for depth in (0, 2):
        before = metrics.dispatches.get(64)
        mb = MicroBatcher(engine, max_delay_ms=60_000.0, pipeline_depth=depth)
        try:
            futures = [mb.submit(x) for burst in bursts for x in burst]
            rows[depth] = np.stack([f.result(timeout=120) for f in futures])
        finally:
            mb.close()
        assert metrics.dispatches.get(64) - before == len(bursts), metrics.summary()
    rec["windows_bitwise"] = {
        "serial_eq_pipelined": bool(np.array_equal(rows[0], rows[2])),
        "serial_eq_apply": bool(np.array_equal(rows[0], direct)),
    }
    log(f"{len(bursts)} windows of 64, serial and pipelined: {rec['windows_bitwise']}")
    assert all(rec["windows_bitwise"].values()), rec["windows_bitwise"]
    assert metrics.compile_count == captures, metrics.summary()

    # -- the closed loop -------------------------------------------------
    images = rng.integers(0, 256, (256, img, img, 3), dtype=np.uint8)
    rec["stream"] = {}
    for delay in STREAM_DELAYS_MS:
        for mode, depth in (("serial", 0), ("pipelined", 2)):
            r = closed_loop(engine, depth, images, delay, seconds)
            rec["stream"][f"{mode} {delay}"] = r
            log(f"closed loop {mode}, max_delay_ms {delay} ({r['in_flight']} in flight, "
                f"{r['seconds']:.2f} s): {r['req_per_s']:.1f} req/s, request p50 "
                f"{r['request_p50_ms']} ms, p99 {r['request_p99_ms']} ms, mean coalesced "
                f"{r['mean_coalesced']:.2f}, dispatches {r['dispatches_per_bucket']}, stages "
                f"{r['stages_ms']}, bottleneck {r['bottleneck']}, overlap efficiency "
                f"{r['overlap_efficiency']}, staging bytes {r['staging_bytes']} on {smi}")

    rec.update(throughput_and_profile(engine, rng, smi, img))
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 7 in {rec['phase_s']:.3f} s")
    return rec


def imagenet_prototypes(classes, g, dev):
    """One seeded prototype per class, (classes, 256, 256, 3) float on
    ``dev``: a smooth random field plus a finer one, drawn from ``g``."""
    def field(res):
        f = torch.rand(classes, 3, res, res, device=dev, generator=g) * 255.0
        return torch.nn.functional.interpolate(f, size=(IMG, IMG), mode="bilinear",
                                               align_corners=False)

    return (0.6 * field(16) + 0.4 * field(64)).permute(0, 2, 3, 1)


def noisy_images(protos, labels, g):
    """uint8 images of ``labels``: their prototypes plus Gaussian noise of
    sigma ``NOISE_SIGMA`` drawn from ``g``, clipped."""
    noise = torch.randn(labels.shape[0], IMG, IMG, 3, device=protos.device, generator=g) * NOISE_SIGMA
    return torch.clamp(protos[labels] + noise, 0, 255).round().to(torch.uint8)


def synthetic_imagenet(classes, per_class, seed, dev):
    """Seeded synthetic 256² uint8 images on ``dev``: a prototype per class
    and Gaussian noise per image; image i has class i % ``classes``.
    Returns (training images, their labels, held-out images, their
    labels): ``per_class`` training images a class, one held-out image a
    class with fresh noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    protos = imagenet_prototypes(classes, g, dev)

    def draw(n):
        labels = torch.arange(n, device=dev) % classes
        return noisy_images(protos, labels, g), labels

    return (*draw(classes * per_class), *draw(classes))


class Stages:
    """Wall time of each stage of a fit, per call (with the number of rows
    it took), with the device synchronized around each; and what the
    checks after the fit need: each estimator's inputs and outputs, the
    first chunk of the Fisher-vector node's inputs."""

    TIMED = {
        "pixel_scaler": (core.PixelScaler, "apply_batch"),
        "gray_scaler": (core.GrayScaler, "apply_batch"),
        "sift": (sift.SIFTExtractor, "apply_batch"),
        "hellinger": (stats_nodes.SignedHellingerMapper, "apply_batch"),
        "lcs": (lcs.LCSExtractor, "apply_batch"),
        "column_sampler": (stats_nodes.ColumnSampler, "apply_batch"),
        "pca_apply": (pca.BatchPCATransformer, "apply_batch"),
        # the cost model's choice at these shapes (tests/test_torch_training.py)
        "pca_fit": (pca.DistributedColumnPCAEstimator, "fit"),
        "gmm_fit": (gmm.GaussianMixtureModelEstimator, "fit"),
        "fv": (fisher_vector.FisherVectorFused, "apply_batch"),
        "solver": (weighted_ls.BlockWeightedLeastSquaresEstimator, "fit"),
    }
    FEATURIZE = ("pixel_scaler", "gray_scaler", "sift", "hellinger", "lcs", "pca_apply")

    def __init__(self, dev):
        self.dev = dev
        self.calls = []  # (stage, rows, seconds)
        self.captured = {"pca_fit": [], "gmm_fit": [], "fv": [], "solver": []}

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @staticmethod
    def rows(args):
        ds = args[0]
        return ds.n if isinstance(ds, Dataset) else int(torch.as_tensor(ds).shape[0])

    @contextlib.contextmanager
    def patched(self):
        saved = []
        for stage, (cls, name) in self.TIMED.items():
            orig = cls.__dict__[name]
            saved.append((cls, name, orig))
            setattr(cls, name, self._wrap(stage, orig))
        try:
            yield self
        finally:
            for cls, name, orig in saved:
                setattr(cls, name, orig)

    def _wrap(self, stage, orig):
        def timed(obj, *args, **kw):
            self.sync()
            t = time.perf_counter()
            out = orig(obj, *args, **kw)
            self.sync()
            sec = time.perf_counter() - t
            rows = self.rows(args)
            self.calls.append((stage, rows, sec))
            if stage in ("pca_fit", "gmm_fit"):
                self.captured[stage].append((args[0], out, sec))
            elif stage == "fv":
                self.captured[stage].append((args[0].padded()[:B].clone(), obj.gmm, sec, rows))
            elif stage == "solver":
                self.captured[stage].append((args[0], args[1], out, sec))
            return out
        return timed

    def summary(self):
        """Per stage and number of rows: the seconds of each call (the
        training set, the node optimizer's sample, the held-out set)."""
        out = {}
        for stage, rows, sec in self.calls:
            out.setdefault(stage, {}).setdefault(f"rows_{rows}", []).append(sec)
        return out

    def featurize_s(self, n):
        """Seconds of the featurize stages over ``n`` rows."""
        return sum(sec for stage, rows, sec in self.calls if stage in self.FEATURIZE and rows == n)


def full_fits(captured):
    """The captured fits over the most rows: each branch's fit on the
    whole training set (the optimizer's fits on its sample are smaller)."""
    most = max(item[0].n for item in captured)
    return [item for item in captured if item[0].n == most]


def _solver_fit(solve, block, lam, mixture_weight, Xs, Ys, d):
    """The weighted solver's fit on ``d``: (W, intercept, seconds, info)."""
    est = weighted_ls.BlockWeightedLeastSquaresEstimator(block, 1, lam, mixture_weight, solve=solve)
    t = time.perf_counter()
    m = est.fit(Dataset.from_array(Xs.to(d)), Dataset.from_array(Ys.to(d)))
    return m.W.cpu(), m.intercept.cpu(), time.perf_counter() - t, _info(m.solver_info)


def solver_check(solve, block, card, cpu, rows, threads=None):
    """The card's fit against the CPU's: each part within ATOL_SOLVER and
    ‖card − CPU‖ / ‖CPU‖ within RTOL_SOLVER_NORM."""
    errs, rel, size = {}, {}, {}
    for i, part in enumerate(("W", "intercept")):
        got, want = card[i], cpu[i]
        errs[part] = max_abs_err(got, want, 0.0, ATOL_SOLVER, f"solver {solve} {part}")
        # the bar beside the size of what it holds
        rel[part] = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        size[part] = float(want.abs().max())
        assert rel[part] <= RTOL_SOLVER_NORM, (solve, part, rel[part])
    check = {"max_abs_err": errs, "bar": ATOL_SOLVER, "rel_norm_err": rel,
             "rel_norm_bar": RTOL_SOLVER_NORM, "max_abs_cpu": size, "card_s": card[2],
             "cpu_s": cpu[2], "cpu_threads": threads or torch.get_num_threads(), "rows": rows,
             "cols": int(card[0].shape[0]), "block": block, "info_card": card[3], "info_cpu": cpu[3]}
    log(f"solver {solve} (block {block}, first {rows} rows, {check['cols']} columns), card vs CPU: "
        f"max abs err {errs} "
        f"(atol {ATOL_SOLVER}) on entries up to {size}; relative norm err {rel} (bar "
        f"{RTOL_SOLVER_NORM}); card {card[2]:.3f} s, CPU {cpu[2]:.3f} s on {check['cpu_threads']} "
        f"threads")
    return check


def cpu_solver(args):
    """In a fresh process (``python3 chip_smoke.py --cpu-solver JSON``):
    the weighted solver's fit on the CPU on ``args["threads"]`` threads,
    from the inputs saved at ``args["inputs"]``, saved to ``args["out"]``."""
    torch.set_num_threads(args["threads"])
    xy = torch.load(args["inputs"])
    fit = _solver_fit(args["solve"], args["block"], args["lam"], args["mixture_weight"],
                      xy["X"], xy["Y"], torch.device("cpu"))
    torch.save(fit, args["out"])


def start_cpu_solver(solve, block, lam, mixture_weight, Xs, Ys, threads):
    """Starts ``cpu_solver`` in a fresh process on ``threads`` threads;
    returns the process, its paths and what it solves.
    The process is killed at exit if it still runs."""
    import atexit

    root = os.path.join(ROOT, "tmp", f"solver_{solve}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    doc = dict(solve=solve, block=block, lam=lam, mixture_weight=mixture_weight,
               threads=threads, inputs=os.path.join(root, "inputs.pt"),
               out=os.path.join(root, "fit.pt"))
    torch.save({"X": Xs.cpu(), "Y": Ys.cpu()}, doc["inputs"])
    log_path = os.path.join(root, "cpu_solver.log")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--cpu-solver",
                                 json.dumps(doc)], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)
    return dict(proc=proc, out=doc["out"], log=log_path, t0=time.perf_counter(), solve=solve,
                block=block, threads=threads)


def finish_cpu_solver(card, started, rows):
    """Waits for ``start_cpu_solver``'s process and holds the card's fit
    against it (``solver_check``)."""
    t = time.perf_counter()
    rc = started["proc"].wait(timeout=P6_CPU_SOLVER_S)
    waited = time.perf_counter() - t
    assert rc == 0, open(started["log"]).read()[-4000:]
    cpu_fit = torch.load(started["out"])
    shutil.rmtree(os.path.dirname(started["out"]), ignore_errors=True)
    check = solver_check(started["solve"], started["block"], card, cpu_fit, rows,
                         threads=started["threads"])
    check["process_s"], check["waited_s"] = time.perf_counter() - started["t0"], waited
    log(f"solver {started['solve']}'s CPU process: {check['process_s']:.3f} s from its start, "
        f"{waited:.3f} s of them spent waiting for it")
    return check


def train_then_serve(dev, smi, classes=1000, per_class=TRAIN_PER_CLASS, solver_rows=SOLVER_ROWS,
                     keep=None):
    """Phase 6. Returns the record written to chip_smoke.json; puts the
    SIFT branch's PCA sample into ``keep`` (phase 11c's input) when it is
    given."""
    conf = flagship.ImageNetSiftLcsFVConfig(**dict(TRAIN_CONF, num_classes=classes))
    rec = {"card": smi, "classes": classes, "train_images": classes * per_class,
           "held_out_images": classes, "conf": dict(TRAIN_CONF, num_classes=classes),
           "noise_sigma": NOISE_SIGMA}
    t0 = time.perf_counter()
    train_x, train_y, test_x, test_y = synthetic_imagenet(classes, per_class, seed=1234, dev=dev)
    rec["data_s"] = time.perf_counter() - t0
    log(f"made {train_x.shape[0]} training and {test_x.shape[0]} held-out images in "
        f"{rec['data_s']:.3f} s")

    # what flagship.run does, with the fitted pipeline kept for serving
    stages = Stages(dev)
    _cuda.reset_launches()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with stages.patched():
        fitted = flagship.build_pipeline(
            Dataset.from_array(train_x), Dataset.from_array(train_y), conf, device=dev
        ).fit()
        stages.sync()
        rec["fit_s"] = time.perf_counter() - t0
        rec["launches_fit"] = dict(_cuda.LAUNCHES)
        t1 = time.perf_counter()
        top5 = fitted(Dataset.from_array(test_x)).array()
        err = 1.0 - float((top5 == test_y[:, None]).any(dim=1).float().mean())
        rec["held_out_s"] = time.perf_counter() - t1
    rec["launches_held_out"] = {k: v - rec["launches_fit"][k] for k, v in _cuda.LAUNCHES.items()}
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    rec["top5_err"] = err
    rec["calls"] = stages.summary()
    log(f"fit in {rec['fit_s']:.3f} s, held-out top-5 in {rec['held_out_s']:.3f} s on {smi}")
    log(f"peak device memory over the fit and the held-out set: {rec['peak_memory_bytes']} bytes on {smi}")
    log(f"kernel launches in the fit: {rec['launches_fit']}; over the held-out set: "
        f"{rec['launches_held_out']}")
    for name in _cuda.LAUNCHES:
        if dev.type == "cuda":
            assert rec["launches_fit"][name] > 0, (name, rec["launches_fit"])
    log(f"held-out top-5 error {err} (limit {MAX_TOP5_ERR}; a fixed guess: {1 - 5 / classes})")
    assert err <= MAX_TOP5_ERR, err

    # -- each estimator on the card against the port on the CPU ------------
    cpu = torch.device("cpu")
    checks = {}
    # wall time of each stage of the fit, synchronized around each call
    n_train = train_x.shape[0]
    stage_s = {"featurize the training set": stages.featurize_s(n_train)}
    pca_fits = full_fits(stages.captured["pca_fit"])
    assert len(pca_fits) == 2, len(pca_fits)
    for data, out, sec in pca_fits:
        rows_in, dims = out.pca_mat.shape
        branch = {128: "sift", 96: "lcs"}[rows_in]
        stage_s[f"PCA fit {branch}"] = sec
        if keep is not None and branch == "sift":
            keep["sift_pca_sample"] = data
        data_cpu = Dataset.from_array(data.array().cpu())
        t = time.perf_counter()
        want = pca.DistributedColumnPCAEstimator(dims).fit(data_cpu).pca_mat
        err_pca = float((out.pca_mat.cpu() - want).abs().max())
        checks[f"pca_{branch}"] = {"max_abs_err": err_pca, "bar": ATOL_PCA, "cpu_s": time.perf_counter() - t,
                                   "input": list(data.array().shape)}
        log(f"PCA {branch}, card vs CPU: max abs err {err_pca} (bar {ATOL_PCA}) on input {list(data.array().shape)}")
        assert err_pca <= ATOL_PCA, (branch, err_pca)

    params = convert.flagship_params(fitted)
    gmm_fits = full_fits(stages.captured["gmm_fit"])
    assert len(gmm_fits) == 2, len(gmm_fits)
    for X, out, sec in gmm_fits:
        branch = next(b for b in ("sift", "lcs")
                      if np.array_equal(params[b]["means"], out.means.cpu().numpy()))
        stage_s[f"GMM fit {branch}"] = sec
        t = time.perf_counter()
        want = gmm.GaussianMixtureModelEstimator(conf.vocab_size, seed=conf.seed).fit(X.array().cpu())
        errs = {}
        for f in ("means", "variances", "weights"):
            g_, w_ = getattr(out, f).cpu(), getattr(want, f)
            errs[f] = max_abs_err(g_, w_, TOL_GMM, TOL_GMM, f"GMM {branch} {f}, card vs CPU")
        checks[f"gmm_{branch}"] = {"max_abs_err": errs, "bar": TOL_GMM, "cpu_s": time.perf_counter() - t,
                                   "input": list(X.array().shape)}
        log(f"GMM {branch}, card vs CPU: max abs err {errs} (rtol = atol = {TOL_GMM}) "
            f"on input {list(X.array().shape)}")

    for x, g, sec, rows in stages.captured["fv"]:
        if rows == n_train:
            branch = next(b for b in ("sift", "lcs")
                          if np.array_equal(params[b]["means"], g.means.cpu().numpy()))
            stage_s[f"FV over the training set {branch}"] = sec
    (X, Y, model, sec), = stages.captured["solver"]
    stage_s["solver"] = sec
    if keep is not None:
        keep["solver_xy"] = (X.array(), Y.array())  # phase 14d's input
    Xs, Ys = X.array()[:solver_rows], Y.array()[:solver_rows]
    rec["solver"] = {"cg_iterations": int(model.solver_info["pcg_iterations"]),
                     "cg_exit_rel_residual": float(model.solver_info["pcg_max_rel_residual"]),
                     "shape": [X.n, X.array().shape[1], Y.array().shape[1]]}
    rec["stage_s"] = stage_s
    for stage, sec in stage_s.items():
        extra = (f", {rec['solver']['cg_iterations']} CG iterations at most per block, exit relative "
                 f"residual {rec['solver']['cg_exit_rel_residual']:.3e}, X {rec['solver']['shape'][:2]}, "
                 f"{rec['solver']['shape'][2]} classes" if stage == "solver" else "")
        log(f"stage {stage}: {sec:.3f} s{extra} on {smi}")
    # PCG's CPU side here; Cholesky's in a process of its own, held against
    # the card's fit after phase 13 (at once when there is no ``keep``)
    lam, mw = conf.lam, conf.mixture_weight
    card = _solver_fit("pcg", 4096, lam, mw, Xs, Ys, dev)
    checks["solver_pcg"] = solver_check("pcg", 4096, card, _solver_fit("pcg", 4096, lam, mw, Xs, Ys, cpu),
                                        solver_rows)
    # (in a rehearsal on the CPU, on this process's thread count, so that
    # both fits are one computation)
    threads = CPU_SOLVER_THREADS if dev.type == "cuda" else torch.get_num_threads()
    chol = (_solver_fit("chol", 256, lam, mw, Xs, Ys, dev),
            start_cpu_solver("chol", 256, lam, mw, Xs, Ys, threads), solver_rows)
    if keep is None:
        checks["solver_chol"] = finish_cpu_solver(*chol)
    else:
        keep["solver_chol"] = chol
    rec["checks"] = checks

    # -- B3 with the fitted GMMs against its plain version --------------------
    fv_rows = []
    seen = set()
    for x, g, _, _ in stages.captured["fv"]:
        if id(g) in seen:
            continue
        seen.add(id(g))
        got = fv_kernel.fisher_vector_stats(x, g.means, g.variances, g.weights, g.weight_threshold)
        want = fv_kernel.fisher_vector_stats_plain(x, g.means, g.variances, g.weights, g.weight_threshold)
        e = max(max_abs_err(a, b, RTOL_FV, ATOL_FV, f"fisher_vector_stats fitted m={x.shape[2]}")
                for a, b in zip(got, want))
        # the largest error as a share of its entry's bar (at most 1), and
        # the largest statistic: a fitted GMM's s2 reaches E[x²] of its
        # projected descriptors
        share = max(float(((a - b).abs() / (ATOL_FV + RTOL_FV * b.abs())).max())
                    for a, b in zip(got, want))
        largest = max(float(b.abs().max()) for b in want)
        fv_rows.append({"m": x.shape[2], "max_abs_err": e, "bar_share": share, "largest_stat": largest,
                        "min_variance": float(g.variances.min()),
                        "max_variance": float(g.variances.max()), "min_weight": float(g.weights.min())})
        log(f"fisher_vector_stats with the fitted GMM at B={x.shape[0]} m={x.shape[2]}: max abs err {e} "
            f"(rtol {RTOL_FV} atol {ATOL_FV}; largest share of an entry's bar {share:.3g}, largest "
            f"statistic {largest:.6g}; variances {fv_rows[-1]['min_variance']:.4g} to "
            f"{fv_rows[-1]['max_variance']:.4g})")
    assert len(fv_rows) == 2, fv_rows
    rec["fv_fitted"] = fv_rows

    # -- serve the trained chain ---------------------------------------------
    feat, head = convert.flagship_from_numpy(
        params, device=dev, sift_step=3, sift_bin=4, sift_scales=4,
        sift_scale_step=conf.sift_scale_step, lcs_stride=conf.lcs_stride,
        lcs_border=conf.lcs_border, lcs_patch=conf.lcs_patch,
    )
    engine = head.compiled(buckets=BUCKETS, featurize=feat, device=dev)
    raw = test_x[:B]
    served = engine.apply(raw.cpu().numpy(), sync=True).cpu()
    own = fitted(Dataset.from_array(raw)).array().cpu()
    rec["served_top5_equal"] = bool(torch.equal(served, own))
    log(f"served top-5 of {B} held-out images equal to the fitted pipeline's: {rec['served_top5_equal']}")
    if not rec["served_top5_equal"]:
        # which rows differ, and how far apart the served chain's scores
        # are there: a tie decided by rounding, or another model
        rows = (served != own).any(1).nonzero().flatten()
        mapper = next(o for o in head.graph.operators.values()
                      if isinstance(o, block_ls.BlockLinearMapper))
        scores = mapper.apply_batch(Dataset.from_array(feat._batch_run(raw[rows]))).array().cpu()
        top = torch.sort(scores, dim=-1, descending=True).values
        log(f"  rows {rows.tolist()}: served {served[rows].tolist()}, fitted {own[rows].tolist()}; "
            f"served scores ranked 4 to 7 {top[:, 3:7].tolist()}")
    assert rec["served_top5_equal"]
    return rec


def _texture_jpeg(h, w, classes, seed):
    """A seeded (h, w) RGB JPEG (PIL, quality 90) of ``classes``: one
    vertical band per class, each with a class-dependent texture frequency
    and tint, plus noise."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    edges = np.linspace(0, w, len(classes) + 1).astype(int)
    for c, lo, hi in zip(classes, edges[:-1], edges[1:]):
        f = 2.0 + 1.5 * (c % 8)
        base = 128.0 + 90.0 * np.sin(x / f + c) * np.cos(y / (f + 0.5 * (c // 8)))
        for k in range(3):
            img[:, lo:hi, k] = base[:, lo:hi] + 12.0 * ((c + k) % 3)
    img += rng.normal(0.0, 8.0, img.shape).astype(np.float32)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def write_image_tars(root, classes, per_train, per_test, sizes, wide, seed=0):
    """A train and a test tar of seeded JPEGs named as ImageNet members
    (``{wnid}_{i}.JPEG``) and the WNID -> class file, under ``root``.
    Images cycle through ``sizes`` ((height, width)); ``wide`` lists
    (size, train count, test count) of larger images, given to the first
    classes. Returns (train tar, test tar, label file)."""
    wnids = [f"n{10_000_000 + c:08d}" for c in range(classes)]
    paths = {}
    for split, per, off in (("train", per_train, 0), ("test", per_test, 10_000)):
        plan = [[sizes[(c + i) % len(sizes)] for i in range(per)] for c in range(classes)]
        c = 0
        for size, n_train, n_test in wide:
            for _ in range(n_train if split == "train" else n_test):
                plan[c % classes][0] = size
                c += 1
        paths[split] = os.path.join(root, f"{split}.tar")
        with tarfile.open(paths[split], "w") as tf:
            for c, wnid in enumerate(wnids):
                for i, (h, w) in enumerate(plan[c]):
                    data = _texture_jpeg(h, w, [c], seed + off + 100 * c + i)
                    info = tarfile.TarInfo(f"{wnid}_{i}.JPEG")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    labels = os.path.join(root, "labels.txt")
    with open(labels, "w") as f:
        f.writelines(f"{w} {c}\n" for c, w in enumerate(wnids))
    return paths["train"], paths["test"], labels


# phase 8: ImageNetSiftLcsFV from tars of JPEGs decoded at native sizes
P8_CLASSES, P8_TRAIN, P8_TEST = 12, 10, 3
P8_SIZES = ((375, 500), (500, 375), (333, 500))
# (size, train images, test images) past the kernels' old width limits
P8_WIDE = (((768, 1024), 2, 2), ((1536, 2048), 1, 1))
P8_VOCAB = 32
# the widths the kernels refused before they walked W in chunks
OLD_WIDTH_LIMIT = {"sift_bin_sample": 728, "plane_sandwich": 1955}
# the streaming feed: the paper's vocabulary, the fused FV at k = 256
P8_STREAM = dict(CONF, vocab=256)
P8_STREAM_ROWS, P8_STREAM_CHECK = 64, 8


def real_image_files(dev, smi, classes=P8_CLASSES, per_train=P8_TRAIN, per_test=P8_TEST,
                     sizes=P8_SIZES, wide=P8_WIDE, vocab=P8_VOCAB, stream=P8_STREAM,
                     stream_rows=P8_STREAM_ROWS, desc_dim=64):
    """Phase 8: ``main`` of ImageNetSiftLcsFV on tars of JPEGs at their
    native sizes, then the streaming loader feeding a serving engine. To
    rehearse it on the CPU at a small size: ``real_image_files(
    torch.device("cpu"), "cpu", classes=4, per_train=25, per_test=2,
    sizes=((40, 48), (48, 40)), wide=(((56, 64), 1, 1),), vocab=2,
    stream=dict(CONF, img=48, desc_dim=8, vocab=4), stream_rows=8,
    desc_dim=8)``."""
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    root = os.path.join(ROOT, "chiprun_out", "phase8")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t = time.perf_counter()
    train_tar, test_tar, labels = write_image_tars(
        root, classes, per_train, per_test, sizes, wide)
    rec = {"write_s": time.perf_counter() - t,
           "train_images": classes * per_train, "test_images": classes * per_test}

    # -- main() on the card, with the kernels' widths and the fit recorded --
    widths = {name: 0 for name in OLD_WIDTH_LIMIT}
    orig = (sift.sift_bin_sample, lcs.plane_sandwich, flagship.run)
    kept = {}

    def sift_width(mag, *a, **k):
        widths["sift_bin_sample"] = max(widths["sift_bin_sample"], mag.shape[2])
        return orig[0](mag, *a, **k)

    def lcs_width(planes, *a, **k):
        widths["plane_sandwich"] = max(widths["plane_sandwich"], planes.shape[3])
        return orig[1](planes, *a, **k)

    def run_keeping_the_fit(*a, **k):
        predictor, kept["fitted"], kept["err"] = flagship.fit_and_score(*a, **k)
        return predictor, kept["err"]

    argv = ["--trainLocation", train_tar, "--testLocation", test_tar, "--labelPath", labels,
            "--descDim", str(desc_dim), "--vocabSize", str(vocab)]
    out = io.StringIO()
    _cuda.reset_launches()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    sift.sift_bin_sample, lcs.plane_sandwich, flagship.run = sift_width, lcs_width, run_keeping_the_fit
    try:
        with contextlib.redirect_stdout(out):
            rc = flagship.main(argv, device=dev)
    finally:
        sift.sift_bin_sample, lcs.plane_sandwich, flagship.run = orig
    rec["main_s"] = time.perf_counter() - t
    printed = out.getvalue().splitlines()
    for ln in printed:
        log(f"  main: {ln}")
    assert rc == 0 and len(printed) == 2 and printed[0].startswith("TEST Top-5 error is "), printed
    rec.update(printed=printed, top5_err=kept["err"], launches=dict(_cuda.LAUNCHES),
               widths=dict(widths))
    if on_card:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"main() on {rec['train_images']} + {rec['test_images']} JPEGs of sizes "
        f"{sorted(set(sizes) | {w[0] for w in wide})}: {rec['main_s']:.3f} s, top-5 error "
        f"{kept['err']}, launches {rec['launches']}, widest call {widths}, peak device memory "
        f"{rec.get('peak_bytes')} bytes on {smi}")
    if on_card:
        assert all(n > 0 for n in rec["launches"].values()), rec["launches"]
        for name, limit in OLD_WIDTH_LIMIT.items():
            assert widths[name] > limit, (name, widths[name], limit)

    # -- 4 test images of different sizes, card against the CPU ------------
    # Two chains on each side: the serving chain's seeded warm start, held
    # at the serving bar (RTOL_FEAT / ATOL_FEAT), and the fitted parameters,
    # held to top-5 equal (the CPU's, and the fitted pipeline's on the card)
    # and, as features, at the serving bar on all but FITTED_BEYOND_SHARE
    # of the entries, none off by more than FITTED_MAX_ABS: a fitted GMM's
    # logits cancel terms of x²/σ² large enough that a SIFT quantization
    # step (±1, the kernels' golden bar) moves a posterior across the 1e-4
    # threshold, which moves a few features by more than ATOL_FEAT
    t = time.perf_counter()
    cpu = torch.device("cpu")
    params = convert.flagship_params(kept["fitted"])
    fitted_chains = {where: convert.flagship_from_numpy(params, device=where) for where in (dev, cpu)}
    seeded = {where: build_flagship_featurize_pipeline(device=where, **CONF)[0] for where in (dev, cpu)}
    test = flagship.ImageNetLoader(test_tar, labels).items()
    picked, seen = [], set()
    for li in sorted(test, key=lambda li: li.image.shape[0] * li.image.shape[1]):
        if li.image.shape not in seen and len(picked) < 4:
            seen.add(li.image.shape)
            picked.append(li)
    checks = []
    for li in picked:
        x = torch.as_tensor(li.image)[None]
        shape = tuple(li.image.shape)
        seeded_err = max_abs_err(seeded[dev]._batch_run(x.to(dev)).cpu(), seeded[cpu]._batch_run(x),
                                 RTOL_FEAT, ATOL_FEAT, f"phase 8 seeded-chain features of a {shape} image")
        (fg, hg), (fc, hc) = fitted_chains[dev], fitted_chains[cpu]
        feat_card, feat_cpu = fg._batch_run(x.to(dev)).cpu(), fc._batch_run(x)
        fitted_err = max_abs_err(feat_card, feat_cpu, 0.0, FITTED_MAX_ABS,
                                 f"phase 8 fitted-chain features of a {shape} image")
        beyond = int((~torch.isclose(feat_card, feat_cpu, rtol=RTOL_FEAT, atol=ATOL_FEAT)).sum())
        assert beyond <= FITTED_BEYOND_SHARE * feat_card.numel(), (
            f"phase 8 fitted-chain features of a {shape} image: {beyond} of {feat_card.numel()} "
            f"entries beyond rtol {RTOL_FEAT} / atol {ATOL_FEAT}, more than {FITTED_BEYOND_SHARE:.1%}")
        top_card, top_cpu = hg._batch_run(feat_card.to(dev)).cpu(), hc._batch_run(feat_cpu)
        fitted_top = kept["fitted"](Dataset.from_items([x[0].to(dev)])).array().cpu()
        checks.append({"shape": shape, "seeded_max_abs_err": seeded_err,
                       "fitted_max_abs_err": fitted_err, "fitted_beyond_serving_bar": beyond,
                       "features": feat_card.numel(),
                       "top5_equal": bool(torch.equal(top_card, top_cpu)),
                       "fitted_top5_equal": bool(torch.equal(top_card, fitted_top))})
        log(f"  {shape}: seeded chain card vs CPU max abs err {seeded_err}; fitted chain max abs err "
            f"{fitted_err}, {beyond} of {feat_card.numel()} beyond rtol {RTOL_FEAT} / atol {ATOL_FEAT}; "
            f"top-5 equal {checks[-1]['top5_equal']}, the fitted pipeline's {checks[-1]['fitted_top5_equal']}")
        assert checks[-1]["top5_equal"] and checks[-1]["fitted_top5_equal"], checks[-1]
    assert len(picked) == min(4, len({li.image.shape for li in test})), [li.image.shape for li in picked]
    rec["card_vs_cpu"] = checks
    rec["card_vs_cpu_s"] = time.perf_counter() - t
    del fitted_chains, seeded

    # -- the streaming loader into a serving engine ------------------------
    from keystone_tpu_torch.loaders.streaming import StreamingImageNetLoader

    img = stream["img"]
    feat, dim = build_flagship_featurize_pipeline(device=dev, **stream)
    engine = feat.compiled(buckets=(stream_rows,), device=dev, name="phase8-stream")
    loader = StreamingImageNetLoader(train_tar, labels, decode_size=img, shard_index=0, num_shards=1)
    t = time.perf_counter()
    n_dec = sum(1 for _ in loader.items())
    decode_s = time.perf_counter() - t
    engine.apply(np.zeros((stream_rows, img, img, 3), np.uint8), sync=True)  # capture
    batch = next(loader.batches(stream_rows, np.uint8))[0]
    engine_s = []
    for _ in range(5):
        t = time.perf_counter()
        engine.apply(batch, sync=True)
        engine_s.append(time.perf_counter() - t)
    _cuda.reset_launches()
    t = time.perf_counter()
    rows, first = 0, None
    for feats, labs, n in loader.featurized_batches(engine, stream_rows):
        if first is None:
            first = feats[:P8_STREAM_CHECK].cpu()
        rows += n
    if on_card:
        torch.cuda.synchronize()
    stream_s = time.perf_counter() - t
    launches = dict(_cuda.LAUNCHES)
    raw = batch[:P8_STREAM_CHECK]
    cpu_feat, _ = build_flagship_featurize_pipeline(device="cpu", **stream)
    want = cpu_feat._batch_run(torch.as_tensor(raw))
    err = max_abs_err(first, want, RTOL_FEAT, ATOL_FEAT,
                      f"phase 8 streamed features at vocab {stream['vocab']}, card vs CPU")
    assert first.shape == (P8_STREAM_CHECK, dim) and bool(torch.isfinite(first).all())
    if on_card:
        assert launches["fisher_vector_stats"] > 0, launches
    from keystone_tpu_torch.native import jpeg_native_available

    engine_med = statistics.median(engine_s)
    rec["stream"] = {
        "images": rows, "decode_images_per_s": n_dec / decode_s,
        "native_decode": jpeg_native_available(),
        "featurize_ex_per_s": rows / stream_s, "seconds": stream_s, "launches": launches,
        "engine_ex_per_s": stream_rows / engine_med, "engine_runs_s": engine_s,
        "first_rows_max_abs_err": err, "vocab": stream["vocab"], "img": img,
    }
    log(f"streaming {rows} images at {img}² (vocab {stream['vocab']}): decode {n_dec / decode_s:.1f} "
        f"images/s (native libjpeg: {rec['stream']['native_decode']}), featurized_batches "
        f"{rows / stream_s:.1f} ex/s ({stream_s:.3f} s, launches {launches}); the engine alone "
        f"{stream_rows / engine_med:.1f} ex/s (median of 5 dispatches of {stream_rows}); first "
        f"{P8_STREAM_CHECK} rows card vs CPU max abs err {err} on {smi}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 8 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# phase 9: VOCSIFTFisher at the paper's widths (main()'s defaults: desc_dim
# 80, vocab 256, lambda 0.5, scale step 0 -> 40,960 features, block 4,096)
P9_CLASSES, P9_TRAIN, P9_TEST = 20, 240, 120
# VOC 2007's common native sizes, (height, width): 500 x 375, 375 x 500 and
# 500 x 333 as width x height
P9_SIZES = ((375, 500), (500, 375), (333, 500))
P9_DESC_DIM, P9_VOCAB, P9_LAM = 80, 256, 0.5
# the bars: the solver card against CPU as phase 6 (a 512-row solve there,
# float32 rounding far below it), the host-block fit against the in-memory
# one as the JAX package's test_host_blocks.py:69, MAP above chance (about
# 0.1: two labels of 20 an image) on classes with coherent textures
RTOL_SOLVER_VOC = 5e-4
RTOL_HOST_FIT, ATOL_HOST_FIT = 2e-4, 2e-5
RTOL_HOST_APPLY, ATOL_HOST_APPLY = 2e-5, 2e-5
MIN_VOC_MAP = 0.3
# the fitted chain's features card against CPU: phase 8's share past
# RTOL_FEAT / ATOL_FEAT, and a cap on any entry set for VOC's unit rows of
# 40,960 entries (a typical entry 1/sqrt(40960) = 4.9e-3; the largest
# error read was 7.3e-5, PERF.md § 4)
FITTED_MAX_ABS_VOC = 1e-3

# scores the test tar with a pipeline saved by another process:
# argv = repo root, saved pipeline, test tar, labels CSV, device, output .npy
SCORE_SAVED = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders.image_loaders import MultiLabelExtractor, VOCLoader
from keystone_tpu_torch.pipelines.images import voc_sift_fisher as voc
from keystone_tpu_torch.workflow.api import FittedPipeline
fitted = FittedPipeline.load(sys.argv[2], device=sys.argv[5])
test = VOCLoader(sys.argv[3], sys.argv[4])
scores = voc.score(fitted, test, sys.argv[5]).cpu()
aps = MeanAveragePrecisionEvaluator(voc.NUM_VOC_CLASSES).evaluate(
    MultiLabelExtractor.apply(test).items(), scores)
np.save(sys.argv[6], scores.numpy())
print(json.dumps({"map": float(np.mean(aps)), "rows": scores.shape[0]}))
"""


@contextlib.contextmanager
def node_times(sync, into, where):
    """Times each transformer's batch apply and each estimator's fit with
    a sync on both sides, into ``into[where[0]][label]`` in seconds: a
    node's own time, since its inputs are computed before it is entered.
    ``where[0]`` names the pass (the fit or the scoring) and may change
    while this is on."""
    depth = [0]
    orig = {(cls, name): cls.__dict__[name] for cls, name in (
        (api.Transformer, "batch_transform"), (api.Estimator, "fit_datasets"),
        (api.LabelEstimator, "fit_datasets"))}

    def timed(fn, prefix):
        def wrapper(self, arg):
            if depth[0]:
                return fn(self, arg)
            depth[0] += 1
            try:
                sync()
                t = time.perf_counter()
                out = fn(self, arg)
                sync()
            finally:
                depth[0] -= 1
            times = into.setdefault(where[0], {})
            label = prefix + type(self).__name__
            times[label] = times.get(label, 0.0) + time.perf_counter() - t
            return out
        return wrapper

    for (cls, name), fn in orig.items():
        setattr(cls, name, timed(fn, "fit " if name == "fit_datasets" else ""))
    try:
        yield into
    finally:
        for (cls, name), fn in orig.items():
            setattr(cls, name, fn)


def write_voc_tars(root, n_train, n_test, sizes, classes=P9_CLASSES, seed=0):
    """A train and a test tar of seeded JPEGs named as VOC members, 1 to 3
    classes an image (the first cycles through the classes), each class a
    textured band, and the labels CSV (1-based classes, one row per image
    and class). Returns (train tar, test tar, labels CSV)."""
    rows, paths = [], {}
    for split, n, off in (("train", n_train, 0), ("test", n_test, 100_000)):
        paths[split] = os.path.join(root, f"{split}.tar")
        with tarfile.open(paths[split], "w") as tf:
            for i in range(n):
                rng = np.random.default_rng((seed, off + i))
                extra = rng.choice(classes, size=int(rng.integers(0, 3)), replace=False)
                labels = list(dict.fromkeys([i % classes] + [int(c) for c in extra]))
                h, w = sizes[i % len(sizes)]
                name = f"VOC2007/JPEGImages/{split}_{i:06d}.jpg"
                data = _texture_jpeg(h, w, labels, seed + off + i)
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                rows += [f"{len(rows)},{c + 1},class{c},{split},{name}\n" for c in labels]
    csv = os.path.join(root, "voclabels.csv")
    with open(csv, "w") as f:
        f.write("id,class,classname,traintesteval,filename\n")
        f.writelines(rows)
    return paths["train"], paths["test"], csv


def host_block_budget(n, k, b, D):
    """Bytes a host-block fit may add on the card: the labels and the
    residual (n, k), the mask, 3 slabs (n, b), W (D, k) and the means, and
    the solve's workspace: 4 (b, b) matrices (gram + λI, its factor, a
    column-major copy for the solver and cuSOLVER's scratch) and a few
    (b, k) and (n, k) temporaries."""
    return 4 * (2 * n * k + n + block_ls.SLABS_ON_CARD * n * b + D * k + D + 4 * b * b
                + 8 * b * k + 4 * n * k)


def voc_sift_fisher(dev, smi, n_train=P9_TRAIN, n_test=P9_TEST, sizes=P9_SIZES,
                    desc_dim=P9_DESC_DIM, vocab=P9_VOCAB, block=voc.BLOCK_SIZE, keep=None):
    """Phase 9: ``VOCSIFTFisher.main`` on tars of JPEGs at VOC's native
    sizes at the paper's widths; the fitted chain's features and the solver
    on the card against the CPU; the solver again from host column blocks;
    the fitted pipeline saved and scored by a fresh process; B3 at VOC's
    shape. To rehearse it on the CPU at a small size:
    ``voc_sift_fisher(torch.device("cpu"), "cpu", n_train=40, n_test=12,
    sizes=((40, 48), (48, 40), (36, 48)), desc_dim=8, vocab=32,
    block=128)``."""
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    root = os.path.join(ROOT, "chiprun_out", "phase9")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t = time.perf_counter()
    train_tar, test_tar, labels = write_voc_tars(root, n_train, n_test, sizes)
    rec = {"write_s": time.perf_counter() - t, "train_images": n_train, "test_images": n_test,
           "sizes": sizes, "desc_dim": desc_dim, "vocab": vocab}

    # -- main(), with the fit's and the scoring pass's launches apart, its
    # decoding and each node's time (a sync around each node) ------------
    kept = {"decode": []}
    stages, where = {}, ["fit"]
    BLS = block_ls.BlockLeastSquaresEstimator
    orig = (voc.run, voc.score, BLS.fit, voc.VOCLoader)

    def loader_timed(*a, **k):
        t = time.perf_counter()
        ds = orig[3](*a, **k)
        kept["decode"].append({"images": ds.n, "s": time.perf_counter() - t})
        return ds

    def run_keeping_the_fit(*a, **k):
        predictor, kept["fitted"], kept["scores"], kept["map"] = voc.fit_and_score(*a, **k)
        return predictor, kept["map"]

    def score_counting(*a, **k):
        sync()
        kept["fit_launches"] = dict(_cuda.LAUNCHES)
        _cuda.reset_launches()
        where[0] = "score"
        out = orig[1](*a, **k)
        sync()
        kept["score_launches"] = dict(_cuda.LAUNCHES)
        return out

    def fit_timed(self, data, labels_ds):
        sync()
        t = time.perf_counter()
        model = orig[2](self, data, labels_ds)
        sync()
        kept["solver_s"] = time.perf_counter() - t
        kept["X"], kept["Y"] = data.to_array_mode().padded(), labels_ds.to_array_mode().padded()
        return model

    argv = ["--trainLocation", train_tar, "--testLocation", test_tar, "--labelPath", labels,
            "--descDim", str(desc_dim), "--vocabSize", str(vocab), "--lambda", str(P9_LAM),
            "--scaleStep", "0"]
    out = io.StringIO()
    _cuda.reset_launches()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    voc.run, voc.score, BLS.fit, voc.VOCLoader = run_keeping_the_fit, score_counting, fit_timed, loader_timed
    try:
        with contextlib.redirect_stdout(out), node_times(sync, stages, where):
            rc = voc.main(argv, device=dev)
    finally:
        voc.run, voc.score, BLS.fit, voc.VOCLoader = orig
    rec["main_s"] = time.perf_counter() - t
    printed = out.getvalue().splitlines()
    for ln in printed:
        log(f"  main: {ln}")
    assert rc == 0 and len(printed) == 2 and printed[0].startswith("TEST MAP is: "), printed
    scores = kept["scores"]
    rec.update(printed=printed, map=kept["map"], fit_launches=kept["fit_launches"],
               score_launches=kept["score_launches"], solver_s=kept["solver_s"],
               features=int(kept["X"].shape[1]))
    if on_card:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    decode_s = sum(d["s"] for d in kept["decode"])
    rec["decode"] = dict(kept["decode"][0], test=kept["decode"][1],
                         images_per_s=(n_train + n_test) / decode_s, s=decode_s)
    rec["stages"] = {p: dict(sorted(st.items(), key=lambda kv: -kv[1])) for p, st in stages.items()}
    rec["other_s"] = rec["main_s"] - decode_s - sum(sum(st.values()) for st in stages.values())
    log(f"  decoding {n_train + n_test} JPEGs {decode_s:.3f} s ({rec['decode']['images_per_s']:.1f} "
        f"images/s); node seconds (a sync around each), the rest of main() {rec['other_s']:.3f} s:")
    for p, st in rec["stages"].items():
        log(f"    {p}: " + ", ".join(f"{name} {v:.3f}" for name, v in st.items()))
    log(f"VOCSIFTFisher main() on {n_train} + {n_test} JPEGs of sizes {sorted(set(sizes))}, "
        f"desc_dim {desc_dim}, vocab {vocab} ({rec['features']} features): {rec['main_s']:.3f} s, "
        f"MAP {kept['map']:.4f}, solver {kept['solver_s']:.3f} s, launches fit "
        f"{rec['fit_launches']} / scoring {rec['score_launches']}, peak device memory "
        f"{rec.get('peak_bytes')} bytes on {smi}")
    assert tuple(scores.shape) == (n_test, P9_CLASSES) and bool(torch.isfinite(scores).all())
    assert rec["features"] == 2 * desc_dim * vocab
    assert kept["map"] >= MIN_VOC_MAP, kept["map"]
    if on_card:
        for phase in ("fit_launches", "score_launches"):
            assert rec[phase]["sift_bin_sample"] > 0 and rec[phase]["fisher_vector_stats"] > 0, rec[phase]
            assert rec[phase]["plane_sandwich"] == 0, rec[phase]

    # -- the fitted chain's features of 4 test images, card against the
    # same pipeline saved and loaded on the CPU ----------------------------
    path = os.path.join(root, "voc_pipeline.pt")
    kept["fitted"].save(path)
    chains = {dev: voc.features_of(kept["fitted"]),
              cpu: voc.features_of(api.FittedPipeline.load(path, device=cpu))}
    test = voc.VOCLoader(test_tar, labels).items()
    picked = [next(li for li in test if li.image.shape[:2] == hw) for hw in dict.fromkeys(sizes)]
    picked += [li for li in test if all(li is not p for p in picked)][: 4 - len(picked)]
    checks = []
    for li in picked:
        x = torch.as_tensor(li.image)[None]
        card, host = chains[dev]._batch_run(x.to(dev)).cpu(), chains[cpu]._batch_run(x)
        shape = tuple(li.image.shape)
        err = max_abs_err(card, host, 0.0, FITTED_MAX_ABS_VOC, f"phase 9 features of a {shape} image")
        beyond = int((~torch.isclose(card, host, rtol=RTOL_FEAT, atol=ATOL_FEAT)).sum())
        assert beyond <= FITTED_BEYOND_SHARE * card.numel(), (
            f"phase 9 features of a {shape} image: {beyond} of {card.numel()} entries beyond "
            f"rtol {RTOL_FEAT} / atol {ATOL_FEAT}, more than {FITTED_BEYOND_SHARE:.1%}")
        checks.append({"shape": shape, "max_abs_err": err, "beyond_serving_bar": beyond,
                       "features": card.numel()})
        log(f"  {shape}: features card vs CPU max abs err {err}, {beyond} of {card.numel()} beyond "
            f"rtol {RTOL_FEAT} / atol {ATOL_FEAT}")
    rec["card_vs_cpu"] = checks
    del chains

    # -- the solver: card against CPU, and from host column blocks --------
    X, Y = kept["X"], kept["Y"]
    n, D, k = X.shape[0], X.shape[1], Y.shape[1]
    if keep is not None:  # phase 11c's input
        keep.update(voc_X=X, voc_Y=Y)
    model = next(o for o in kept["fitted"].graph.operators.values()
                 if isinstance(o, block_ls.BlockLinearMapper))
    est = BLS(voc.BLOCK_SIZE, 1, P9_LAM)
    t1 = time.perf_counter()
    on_cpu = est.fit(Dataset.from_array(X.cpu()), Dataset.from_array(Y.cpu()))
    rec["solver_cpu_s"] = time.perf_counter() - t1
    rel = {}
    for what in ("W", "intercept"):
        got, want = getattr(model, what).cpu(), getattr(on_cpu, what)
        rel[what] = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert rel[what] <= RTOL_SOLVER_VOC, (what, rel[what])
    rec["solver_rel_err"] = rel
    log(f"  solver card vs CPU: ‖ΔW‖/‖W‖ {rel['W']:.3g}, ‖Δb‖/‖b‖ {rel['intercept']:.3g} "
        f"(CPU fit {rec['solver_cpu_s']:.3f} s)")

    est = BLS(block, 1, P9_LAM)
    fits = {}
    for mode in ("in_memory", "host_blocks"):
        data = (Dataset.from_array(X) if mode == "in_memory" else
                Dataset.host_blocks_from_batches([X[i:i + 64] for i in range(0, n, 64)],
                                                 block, device=dev))
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t1 = time.perf_counter()
        m = est.fit(data, Dataset.from_array(Y))
        sync()
        fits[mode] = {"model": m, "data": data, "s": time.perf_counter() - t1,
                      "peak_above_start_bytes": (torch.cuda.max_memory_allocated(dev) - base)
                      if on_card else None}
    err = max_abs_err(fits["host_blocks"]["model"].W, fits["in_memory"]["model"].W,
                      RTOL_HOST_FIT, ATOL_HOST_FIT, "phase 9 host-block fit against the in-memory one")
    # the mapper's blockwise apply, slab by slab, against its dense apply
    # (the JAX package's bar, test_host_blocks.py:205)
    model = fits["host_blocks"]["model"]
    apply_err = max_abs_err(model.apply_batch(fits["host_blocks"]["data"]).array(),
                            model.apply_batch(fits["in_memory"]["data"]).array(),
                            RTOL_HOST_APPLY, ATOL_HOST_APPLY, "phase 9 apply from host blocks against dense")
    budget = host_block_budget(n, k, block, D)
    rec["host_blocks"] = {mode: {kk: v for kk, v in f.items() if kk not in ("model", "data")}
                          for mode, f in fits.items()}
    rec["host_blocks"].update(max_abs_err=err, apply_max_abs_err=apply_err, budget_bytes=budget,
                              block=block, slabs=-(-D // block), slab_bytes=4 * n * block)
    log(f"  host blocks ({-(-D // block)} slabs of {n} x {block}) against in memory: max abs err {err} "
        f"(their apply {apply_err}); "
        f"seconds {fits['host_blocks']['s']:.3f} / {fits['in_memory']['s']:.3f}; peak above the start "
        f"{fits['host_blocks']['peak_above_start_bytes']} / {fits['in_memory']['peak_above_start_bytes']} "
        f"bytes (budget {budget} bytes) on {smi}")
    if on_card:
        assert fits["host_blocks"]["peak_above_start_bytes"] <= budget, rec["host_blocks"]
    del fits

    # -- persistence: a fresh process loads the pipeline and scores --------
    params = convert.voc_params(kept["fitted"])
    scored = os.path.join(root, "scores_loaded.npy")
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SCORE_SAVED, ROOT, path, test_tar, labels, str(dev), scored],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    same = bool(np.array_equal(np.load(scored), scores.cpu().numpy()))
    rec["persistence"] = {"file_bytes": os.path.getsize(path),
                          "param_bytes": sum(np.asarray(v).nbytes for v in params.values()),
                          "subprocess_s": time.perf_counter() - t1, "map": loaded["map"],
                          "scores_equal": same}
    log(f"  saved pipeline {rec['persistence']['file_bytes']} bytes (parameters "
        f"{rec['persistence']['param_bytes']}); a fresh process scored the test tar in "
        f"{rec['persistence']['subprocess_s']:.3f} s: scores equal bit for bit {same}, MAP "
        f"{loaded['map']} (fitting process {kept['map']})")
    assert same and loaded["map"] == kept["map"], rec["persistence"]
    # about the size of the parameters: no caches, no discarded columns
    assert rec["persistence"]["file_bytes"] <= 1.05 * rec["persistence"]["param_bytes"] + 65536, (
        rec["persistence"])

    # -- B3 at VOC's shape: one 375 x 500 image's descriptors --------------
    fv_node = next(o for o in kept["fitted"].graph.operators.values()
                   if isinstance(o, (fisher_vector.FisherVector, fisher_vector.FisherVectorFused)))
    pca_node = next(o for o in kept["fitted"].graph.operators.values()
                    if isinstance(o, pca.BatchPCATransformer))
    sift_node = next(o for o in kept["fitted"].graph.operators.values()
                     if isinstance(o, sift.SIFTExtractor))
    img = torch.as_tensor(picked[0].image).to(dev)
    gray = core.GrayScaler().apply(core.PixelScaler().apply(img))
    x = torch.einsum("dk,ndm->nkm", pca_node.pca_mat, sift_node.extract(gray[None]))
    g = fv_node.gmm
    args = (x, g.means, g.variances, g.weights, g.weight_threshold)
    d, m = x.shape[1], x.shape[2]
    errs = [max_abs_err(a, b, RTOL_FV, ATOL_FV, f"phase 9 fisher_vector_stats d={d} k={g.k} m={m}")
            for a, b in zip(fv_kernel.fisher_vector_stats(*args),
                            fv_kernel.fisher_vector_stats_plain(*args))]
    b_ms, b_by = bound(fv_flops(1, m, d, g.k), 4 * (x.numel() + 2 * d * g.k + g.k + (1 + 2 * d) * g.k))
    b3 = {"shape": f"B=1 d={d} k={g.k} m={m} ({tuple(picked[0].image.shape)} image, fitted GMM)",
          "max_abs_err": max(errs), "bound_ms": b_ms, "bound_by": b_by, **_fv_extra([x], d, g.k)}
    if on_card:
        b3.update(ms=time_ms(lambda: fv_kernel.fisher_vector_stats(*args)),
                  plain_ms=time_ms(lambda: fv_kernel.fisher_vector_stats_plain(*args)),
                  library_ms=time_ms(lambda: fv_library(*args)))
        b3["bound_share"] = b_ms / b3["ms"]
        log(f"  B3 [{b3['shape']}]: {b3['ms']:.3f} ms (plain {b3['plain_ms']:.3f}, library "
            f"{b3['library_ms']:.3f}, bound {b_ms:.4f} by {b_by}, share {b3['bound_share']:.3f}, "
            f"tensor-core bound {b3['bound_tc_ms']:.4f}, copies of {b3['copy_bytes']} bytes), "
            f"max abs err {b3['max_abs_err']:.3g} on {smi}")
    rec["b3_voc_shape"] = b3
    # and at the batch the fit gives it: a chunk of CHUNK_ROWS test images
    # of this descriptor count (map_rows; 5 calls for 240 training images)
    xs = []
    for li in test:
        gray = core.GrayScaler().apply(core.PixelScaler().apply(torch.as_tensor(li.image).to(dev)))
        xi = torch.einsum("dk,ndm->nkm", pca_node.pca_mat, sift_node.extract(gray[None]))
        if xi.shape[2] == m:
            xs.append(xi)
        if len(xs) == CHUNK_ROWS:
            break
    xb = torch.cat(xs)
    del xs
    args = (xb, g.means, g.variances, g.weights, g.weight_threshold)
    nb = xb.shape[0]
    errs = [max_abs_err(a, b, RTOL_FV, ATOL_FV, f"phase 9 fisher_vector_stats B={nb} d={d} k={g.k} m={m}")
            for a, b in zip(fv_kernel.fisher_vector_stats(*args),
                            fv_kernel.fisher_vector_stats_plain(*args))]
    b_ms, b_by = bound(fv_flops(nb, m, d, g.k),
                       4 * (xb.numel() + 2 * d * g.k + g.k + nb * (1 + 2 * d) * g.k))
    b3b = {"shape": f"B={nb} d={d} k={g.k} m={m} (the fit's chunk of VOC images, fitted GMM)",
           "max_abs_err": max(errs), "bound_ms": b_ms, "bound_by": b_by, **_fv_extra([xb], d, g.k)}
    if on_card:
        b3b.update({k: time_ms(fn, calls=3, rounds=3) for k, fn in (
            ("ms", lambda: fv_kernel.fisher_vector_stats(*args)),
            ("plain_ms", lambda: fv_kernel.fisher_vector_stats_plain(*args)),
            ("library_ms", lambda: fv_library(*args)))})
        b3b["bound_share"] = b_ms / b3b["ms"]
        log(f"  B3 [{b3b['shape']}]: {b3b['ms']:.3f} ms (plain {b3b['plain_ms']:.3f}, library "
            f"{b3b['library_ms']:.3f}, bound {b_ms:.4f} by {b_by}, share {b3b['bound_share']:.3f}, "
            f"tensor-core bound {b3b['bound_tc_ms']:.4f}, copies of {b3b['copy_bytes']} bytes), "
            f"max abs err {b3b['max_abs_err']:.3g} on {smi}")
    rec["b3_voc_chunk"] = b3b
    del xb, args
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 9 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# phase 10: the random-features image apps at CIFAR-10's and MNIST's sizes
# (the JAX package's defaults: 100 filters, patch 6, pool 14/13, alpha
# 0.25, lambda 0, a 100,000-row whitener sample; KRR gamma 2e-5, block
# 512; MNIST 4 FFTs, block 2,048)
P10_CIFAR, P10_MNIST = (50_000, 10_000), (60_000, 10_000)
# the augmented variants make 10 crops an image: 5,000 + 1,000 images give
# 50,000 train crops and 10,000 test patches (the whole set would be
# 500,000 crops, 72 GB of convolution output and 977 KRR blocks)
P10_AUG = (5_000, 1_000)
P10_CHECK_ROWS, P10_KRR_ROWS = 256, 2_048
# the augmented kernel variant at lambda 1 (its JAX test's): at the
# config's lambda 0 its 200 features leave each 512-row diagonal block of
# the kernel singular
P10_AUG_KERNEL_LAM = 1.0
# the JAX tests' accuracy bars (tests/pipelines/test_random_patch_cifar.py,
# test_cifar_apps.py, test_mnist_random_fft.py)
P10_MIN_ACC = {"random_patch_cifar": 0.6, "random_patch_cifar_kernel": 0.6,
               "linear_pixels": 0.8, "random_cifar": 0.3,
               "random_patch_cifar_augmented_kernel": 0.5, "mnist_random_fft": 0.9}
# the JAX tests' bars: the Convolver (tests/ops/test_images.py, atol
# 1e-3), cached KRR against uncached (tests/ops/test_kernel.py:149), its W
# card against CPU (:73) and the device solve against the host one (:189),
# the fused FFT features against the gathered branches
# (tests/ops/test_stats.py:158; atol scaled by the features' largest
# magnitude: byte-range pixels make FFT entries of order 1e5, not 1)
ATOL_CONV = 1e-3
RTOL_KRR_CACHED, ATOL_KRR_CACHED = 2e-5, 1e-6
ATOL_KRR_W = 1e-3
# (the device-vs-host atol is the JAX test's 5e-5, set at 96 rows, widened
# to 2e-4 from a reading at these 2,048 rows, whose kernel is far worse
# conditioned: 9.6e-5, 3 of 20,480 entries past the JAX bar; PERF.md § 6)
RTOL_KRR_HOST, ATOL_KRR_HOST = 5e-4, 2e-4
# those three run at the JAX test's lambda 0.4 (tests/ops/test_kernel.py:179):
# at the app's lambda 0 the 512-row diagonal blocks of this kernel (entries
# near 1) are so ill-conditioned that float32 and float64 solves part by
# hundreds (a CPU rehearsal at 1,024 images: 525), and two epochs cached
# and uncached by 4.3e5 (PERF.md § 6)
P10_KRR_CHECK_LAM = 0.4
RTOL_FFT, ATOL_FFT = 1e-5, 1e-5


@contextlib.contextmanager
def recorded(owner, name, sync, into):
    """``owner.name`` (a module's function or a class's static method)
    replaced while this is on by a wrapper that records, in
    ``into[name]``, the seconds of its calls (a sync on both sides), their
    count and the last call's arguments and result."""
    orig = owner.__dict__[name]
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    def wrapper(*a, **kw):
        sync()
        t = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        rec = into.setdefault(name, {"s": 0.0, "calls": 0})
        rec["s"] += time.perf_counter() - t
        rec["calls"] += 1
        rec["args"], rec["out"] = a, out
        return out

    setattr(owner, name, staticmethod(wrapper) if isinstance(orig, staticmethod) else wrapper)
    try:
        yield into
    finally:
        setattr(owner, name, orig)


def write_cifar(path, labels, images):
    """CIFAR binary records: a label byte, then the three channel planes."""
    n = len(labels)
    planes = np.asarray(images).astype(np.uint8).transpose(0, 3, 1, 2).reshape(n, -1)
    np.concatenate([np.asarray(labels, np.uint8)[:, None], planes], axis=1).tofile(path)


def spatial_cifar(n, rng):
    """LinearPixels' data (tests/pipelines/test_cifar_apps.py): a spatial
    gray pattern per class, since a color blob collapses under
    GrayScaler to one level that no model linear in gray pixels separates
    ten ways. Returns (labels, (n, 32, 32, 3) byte-valued images)."""
    x, y = np.meshgrid(np.arange(32), np.arange(32))
    patterns = np.stack([
        100 + 80 * np.sin(2 * np.pi * (x * np.cos(a) + y * np.sin(a)) / p)
        for a, p in zip(np.linspace(0, np.pi, 10, endpoint=False),
                        [4, 6, 8, 10, 12, 5, 7, 9, 11, 13])
    ])
    ys = rng.integers(0, 10, n)
    imgs = patterns[ys] + rng.normal(0, 10, (n, 32, 32))
    return ys, np.repeat(np.round(imgs)[..., None], 3, axis=3).clip(0, 255)


def write_mnist_csv(path, labels, pixels, rows_per_write=10_000):
    """MNIST-layout CSV rows: the 1-based label, then integer pixels."""
    table = np.array([str(i) for i in range(256)], dtype=object)
    with open(path, "w") as f:
        for s in range(0, len(labels), rows_per_write):
            rows = np.concatenate([np.asarray(labels[s : s + rows_per_write])[:, None] + 1,
                                   pixels[s : s + rows_per_write]], axis=1).astype(np.int64)
            f.write("\n".join(",".join(r) for r in table[rows]) + "\n")


def _subset(d: LabeledImages, n):
    return LabeledImages(Dataset.from_array(d.labels.array()[:n]),
                         Dataset.from_array(d.images.array()[:n]))


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _reset_peak(dev):
    PipelineEnv.get_or_create().reset()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _outs(rec):
    """The recorded calls without their arguments and results, for the
    JSON record."""
    return {k: {kk: vv for kk, vv in v.items() if kk not in ("args", "out")}
            for k, v in rec.items()}


def random_features(dev, smi, cifar=P10_CIFAR, mnist_rows=P10_MNIST, aug=P10_AUG,
                    check_rows=P10_CHECK_ROWS, krr_rows=P10_KRR_ROWS, serve_img=16):
    """Phase 10: the random-features apps on the card from files the
    ported loaders read. To rehearse it on the CPU at a small size:
    ``random_features(torch.device("cpu"), "cpu", cifar=(3072, 256),
    mnist_rows=(8192, 512), aug=(100, 20), check_rows=32, krr_rows=512)``
    (about a minute)."""
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # the data, in the loaders' formats, under the gitignored tmp/
    root = os.path.join(ROOT, "tmp", "phase10")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t = time.perf_counter()
    files = {k: os.path.join(root, k) for k in (
        "cifar_train.bin", "cifar_test.bin", "spatial_train.bin", "spatial_test.bin",
        "mnist_train.csv", "mnist_test.csv")}
    blobs = rpc.synthetic_cifar(n_train=cifar[0], n_test=cifar[1], seed=0)
    for split, d in zip(("train", "test"), blobs):
        write_cifar(files[f"cifar_{split}.bin"], d.labels.array().numpy(),
                    np.round(d.images.array().numpy()))
    del blobs
    srng = np.random.default_rng(1)
    for split, n in zip(("train", "test"), cifar):
        write_cifar(files[f"spatial_{split}.bin"], *spatial_cifar(n, srng))
    mtrain, mtest = mnist.synthetic_mnist(n_train=mnist_rows[0], n_test=mnist_rows[1], seed=0)
    # bytes as MNIST's are: about half zero, mean 36 (an offset of 128
    # instead costs both packages' float32 centred Grams at lambda 0 most
    # of their accuracy: 0.49 here, 0.29 in JAX, at 8,192 rows on the CPU)
    for split, d in (("train", mtrain), ("test", mtest)):
        px = np.clip(np.round(d.data.array().numpy() * 40), 0, 255)
        write_mnist_csv(files[f"mnist_{split}.csv"], d.labels.array().numpy(), px)
    del mtrain, mtest
    rec = {"write_s": time.perf_counter() - t, "cifar": cifar, "mnist": mnist_rows, "aug": aug,
           "bytes": {k: os.path.getsize(v) for k, v in files.items()}}
    log(f"phase 10 data written in {rec['write_s']:.3f} s: {rec['bytes']}")

    def accuracy(name, metrics):
        acc = metrics.total_accuracy
        log(f"{name}: accuracy {acc:.4f} (bar > {P10_MIN_ACC.get(name, 0.0)})")
        assert acc > P10_MIN_ACC.get(name, -1.0), (name, acc)
        return acc

    # -- 10a. RandomPatchCifar.main() -----------------------------------
    _reset_peak(dev)
    calls, times = {}, {}
    argv = ["--trainLocation", files["cifar_train.bin"], "--testLocation", files["cifar_test.bin"]]
    with recorded(rpc, "run", sync, calls), recorded(rpc, "CifarLoader", sync, calls), \
            recorded(rpc, "build_filters", sync, calls), node_times(sync, times, ["main"]):
        t = time.perf_counter()
        rpc.main(argv, device=dev)
        main_s = time.perf_counter() - t
    pipeline, metrics = calls["run"]["out"]
    a = {"main_s": main_s, "calls": _outs(calls), "node_times": times["main"],
         "peak_bytes": _peak(dev), "accuracy": accuracy("random_patch_cifar", metrics)}
    log(f"10a RandomPatchCifar.main() in {main_s:.3f} s, peak device memory "
        f"{a['peak_bytes']} bytes, on {smi}; calls {a['calls']}; by node (s): {times['main']}")
    # card against the port on the CPU, with the card's filters and fits
    fitted = pipeline.fit()
    params = convert.random_patch_cifar_params(fitted)
    on_cpu = convert.random_patch_cifar_from_numpy(params, device=cpu)
    test = CifarLoader(files["cifar_test.bin"])
    imgs = test.images.array()[:check_rows]
    conv_card = next(o for o in fitted.graph.operators.values() if isinstance(o, core.Convolver))
    conv_cpu = next(o for o in on_cpu.graph.operators.values() if isinstance(o, core.Convolver))
    err = max_abs_err(conv_card.apply_batch(Dataset.from_array(imgs.to(dev))).array().cpu(),
                      conv_cpu.apply_batch(Dataset.from_array(imgs)).array(), 0.0, ATOL_CONV,
                      f"10a Convolver of {check_rows} test images, card vs CPU")
    pred_card = fitted(Dataset.from_array(imgs.to(dev))).array().cpu()
    pred_cpu = on_cpu(Dataset.from_array(imgs)).array()
    a.update(conv_max_abs_err=err, argmax_equal=bool(torch.equal(pred_card, pred_cpu)))
    log(f"10a card vs CPU on {check_rows} test images: Convolver max abs err {err:.3g} "
        f"(atol {ATOL_CONV}), argmax equal {a['argmax_equal']}")
    assert a["argmax_equal"]
    rec["random_patch_cifar"] = a
    del pipeline, fitted, calls

    # -- 10b. random_patch_cifar_kernel ---------------------------------
    _reset_peak(dev)
    train, test = CifarLoader(files["cifar_train.bin"]), CifarLoader(files["cifar_test.bin"])
    kconf = apps.RandomCifarKernelConfig()
    times = {}
    with node_times(sync, times, ["kernel"]):
        t = time.perf_counter()
        kpipe, kmetrics = apps.random_patch_cifar_kernel(train, test, kconf, device=dev)
        k_s = time.perf_counter() - t
    n_blocks = -(-cifar[0] // kconf.block_size)
    fit_s = times["kernel"]["fit KernelRidgeRegression"]
    b = {"app_s": k_s, "node_times": times["kernel"], "blocks": n_blocks, "fit_s": fit_s,
         "blocks_per_s": n_blocks / fit_s, "peak_bytes": _peak(dev),
         "accuracy": accuracy("random_patch_cifar_kernel", kmetrics)}
    log(f"10b random_patch_cifar_kernel in {k_s:.3f} s: KRR fit {fit_s:.3f} s for {n_blocks} "
        f"blocks ({b['blocks_per_s']:.1f} blocks/s), peak {b['peak_bytes']} bytes, on {smi}; "
        f"by node (s): {times['kernel']}")
    mapper = next(o for o in kpipe.fit().graph.operators.values()
                  if isinstance(o, krr.KernelBlockLinearMapper))
    X = Dataset.from_array(mapper.kernel_transformer.train_X)
    Y = ClassLabelIndicators(10).apply_batch(Dataset.from_array(train.labels.array().to(dev)))
    del kpipe, mapper
    est = krr.KernelRidgeRegression(krr.GaussianKernelGenerator(kconf.gamma), P10_KRR_CHECK_LAM,
                                    kconf.block_size, 2, block_permuter=kconf.seed)
    fits = {}
    for cached in (False, True):
        _reset_peak(dev)
        sync()
        t = time.perf_counter()
        fits[cached] = dataclasses.replace(est, cache_kernel=cached).fit(X, Y).model
        sync()
        b[f"epochs2_{'cached' if cached else 'uncached'}"] = {
            "fit_s": time.perf_counter() - t, "peak_bytes": _peak(dev)}
    b["cached_max_abs_err"] = max_abs_err(fits[True], fits[False], RTOL_KRR_CACHED,
                                          ATOL_KRR_CACHED, "10b 2 epochs cached vs uncached")
    log(f"10b 2 epochs at lambda {P10_KRR_CHECK_LAM}: uncached {b['epochs2_uncached']}, cached {b['epochs2_cached']} "
        f"(s, bytes) on {smi}; W cached vs uncached max abs err {b['cached_max_abs_err']:.3g}")
    del fits
    sub_X = Dataset.from_array(X.array()[:krr_rows])
    sub_Y = Dataset.from_array(Y.array()[:krr_rows])
    one = dataclasses.replace(est, num_epochs=1)
    W_card = one.fit(sub_X, sub_Y).model.cpu()
    W_host = dataclasses.replace(one, solve="host").fit(sub_X, sub_Y).model.cpu()
    W_cpu = one.fit(Dataset.from_array(sub_X.array().cpu()),
                    Dataset.from_array(sub_Y.array().cpu())).model
    b["subset_card_vs_cpu"] = max_abs_err(W_card, W_cpu, 0.0, ATOL_KRR_W,
                                          f"10b W of {krr_rows} rows, card vs CPU")
    b["subset_device_vs_host"] = max_abs_err(W_card, W_host, RTOL_KRR_HOST, ATOL_KRR_HOST,
                                             f"10b W of {krr_rows} rows, device vs host solve")
    log(f"10b on {krr_rows} rows at lambda {P10_KRR_CHECK_LAM}: W card vs CPU max abs err {b['subset_card_vs_cpu']:.3g}, "
        f"device vs host solve {b['subset_device_vs_host']:.3g}")
    rec["random_patch_cifar_kernel"] = b
    del X, Y, sub_X, sub_Y

    # -- 10c. MnistRandomFFT.main(), fused and gathered ------------------
    _reset_peak(dev)
    calls, times = {}, {}
    argv = ["--trainLocation", files["mnist_train.csv"], "--testLocation", files["mnist_test.csv"]]
    with recorded(mnist, "run", sync, calls), recorded(LabeledData, "from_csv", sync, calls), \
            node_times(sync, times, ["fused"]):
        t = time.perf_counter()
        mnist.main(argv, device=dev)
        main_s = time.perf_counter() - t
    c = {"main_s": main_s, "csv_s": calls["from_csv"]["s"], "calls": _outs(calls),
         "peak_bytes": _peak(dev)}
    metrics = calls["run"]["out"][1]
    c["fused"] = {"accuracy": accuracy("mnist_random_fft", metrics),
                  "fit_s": times["fused"]["fit BlockLeastSquaresEstimator"],
                  "node_times": times["fused"]}
    mtrain, mtest = calls["run"]["args"][:2]  # as main() read them
    with node_times(sync, times, ["gathered"]):
        _, gmetrics = mnist.run(mtrain, mtest, mnist.MnistRandomFFTConfig(fused=False), device=dev)
    c["gathered"] = {"accuracy": accuracy("mnist_random_fft", gmetrics),
                     "fit_s": times["gathered"]["fit BlockLeastSquaresEstimator"],
                     "node_times": times["gathered"]}
    x = Dataset.from_array(mtest.data.array()[:4096].to(dev))
    fused = stats_nodes.RandomFFTFeatures.create(784, 4, seed=0, device=dev).apply_batch(x).array()
    branches = api.Pipeline.gather([
        stats_nodes.RandomSignNode.create(784, seed=i, device=dev)
        .and_then(stats_nodes.PaddedFFT()).and_then(stats_nodes.LinearRectifier(0.0))
        for i in range(4)]).and_then(mnist.VectorCombiner()).fit()
    scale = float(fused.abs().max())
    c["fused_vs_gathered_max_abs_err"] = max_abs_err(
        fused, branches(x).array(), RTOL_FFT, ATOL_FFT * scale,
        "10c fused FFT features vs the gathered branches")
    log(f"10c MnistRandomFFT.main() in {main_s:.3f} s (CSV parse {c['csv_s']:.3f} s for "
        f"{calls['from_csv']['calls']} files), fit {c['fused']['fit_s']:.3f} s fused / "
        f"{c['gathered']['fit_s']:.3f} s gathered, accuracy {c['fused']['accuracy']:.4f} / "
        f"{c['gathered']['accuracy']:.4f}; features fused vs gathered max abs err "
        f"{c['fused_vs_gathered_max_abs_err']:.3g} of entries up to {scale:.4g}; peak "
        f"{c['peak_bytes']} bytes, on {smi}")
    rec["mnist_random_fft"] = c
    del x, fused, branches, mtrain, mtest, calls

    # -- 10d. the other CIFAR apps --------------------------------------
    d = {}
    spatial = (CifarLoader(files["spatial_train.bin"]), CifarLoader(files["spatial_test.bin"]))
    blob = (CifarLoader(files["cifar_train.bin"]), CifarLoader(files["cifar_test.bin"]))
    runs = (
        ("linear_pixels", lambda: apps.linear_pixels(*spatial, device=dev)),
        ("random_cifar", lambda: apps.random_cifar(*blob, device=dev)),
        ("random_patch_cifar_augmented", lambda: apps.random_patch_cifar_augmented(
            _subset(blob[0], aug[0]), _subset(blob[1], aug[1]),
            apps.RandomCifarAugmentedConfig(), device=dev)),
        ("random_patch_cifar_augmented_kernel", lambda: apps.random_patch_cifar_augmented_kernel(
            _subset(blob[0], aug[0]), _subset(blob[1], aug[1]),
            apps.RandomCifarAugmentedKernelConfig(lam=P10_AUG_KERNEL_LAM), device=dev)),
    )
    for name, fn in runs:
        _reset_peak(dev)
        times = {}
        with node_times(sync, times, [name]):
            t = time.perf_counter()
            _, m = fn()
            sync()
            secs = time.perf_counter() - t
        d[name] = {"s": secs, "node_times": times[name], "peak_bytes": _peak(dev),
                   "accuracy": accuracy(name, m)}
        log(f"10d {name} in {secs:.3f} s, peak {d[name]['peak_bytes']} bytes, on {smi}; "
            f"by node (s): {times[name]}")
    rec["other_apps"] = d
    del spatial, blob
    _reset_peak(dev)

    # -- 10e. the conv stack served through CUDA graphs -----------------
    feat, dim = build_featurize_pipeline(device=dev)
    engine = feat.compiled(buckets=BUCKETS, device=dev, name="phase10")
    capture_s = engine.warmup(example=np.zeros((serve_img, serve_img, 3), np.uint8))
    rng = np.random.default_rng(23)
    e = {"feature_dim": dim, "capture_s": capture_s, "replay_equal": {}}
    for bucket in BUCKETS:
        raw = rng.integers(0, 256, (bucket, serve_img, serve_img, 3), dtype=np.uint8)
        replay = engine.apply(raw, sync=True)
        eager = engine._run_bucket(torch.as_tensor(raw).to(dev))
        e["replay_equal"][bucket] = bool(torch.equal(replay, eager))
    log(f"10e conv stack ({dim} features): captures {capture_s} s, replays equal to the eager "
        f"chain bit for bit: {e['replay_equal']}")
    assert all(e["replay_equal"].values()), e
    e.update(throughput_and_profile(engine, rng, smi, serve_img))
    rec["serve_conv"] = e
    del engine, feat
    PipelineEnv.get_or_create().reset()
    shutil.rmtree(root, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# phase 11: fits past the card's memory, the flagship's other estimators
# and TIMIT at its published width. 11a: phase 6's configuration at the
# paper's vocabulary (2 branches x 2 x 64 x 256 = 65,536 features, 16
# column blocks of 4,096), the featurizer fit on 1,000 images, then 4,000
# and 16,000 images streamed in chunks of 64 into host column blocks and
# the weighted solver fit from them
P11_VOCAB, P11_FIT_IMAGES, P11_HELD_OUT, P11_CHUNK = 256, 1_000, 1_000, 64
P11_STREAMS = (4_000, 16_000)
# the host-block fit against the in-device fit of the same features,
# ‖ΔW‖/‖W‖ and ‖Δb‖/‖b‖: the first reading was 0.0 (the same operations on
# a contiguous slab in place of a strided view, bit for bit; PERF.md § 6);
# the bar leaves room for float32 rounding should cuBLAS take another
# algorithm for one of the two layouts
RTOL_STREAM_FIT = 1e-6
# 11c: the JAX tests' bars: training argmax accuracy of both weighted
# solvers (tests/ops/test_weighted_ls.py:107-120), the cosines of the
# principal angles of the sketch PCA against the exact one
# (tests/ops/test_pca_zca.py:55-61); the solvers at the flagship's lambda
# and mixture weight, on phase 9's features
P11_MIN_TRAIN_ACC, P11_MIN_ANGLE = 0.95, 0.99
# the sketch's principal-angle bar holds at the JAX defaults (p 10, q 2)
# on data with a spectral gap at 64, as the JAX test's data has one at its
# rank; SIFT descriptors have none there (sigma_64 / sigma_65 = 1.016 on a
# CPU rehearsal's sample, where q = 2 leaves one direction at a cosine of
# 0.40 and q = 8 reaches 0.9956), so on them the bar is held at 16 power
# iterations and the defaults' angle and captured variance are printed
P11_POWER_ITERS = 16
BARRED_SKETCHES = {("rank 64 plus noise", 2), ("SIFT descriptor sample", P11_POWER_ITERS)}
# 11d: TIMIT's published width (440 -> 40 x 4,096 cosines, 147 classes;
# timit.py:37-51's defaults) on 32,768 + 8,192 seeded frames, and the bar
# of tests/pipelines/test_text_pipelines.py:82-99
P11_TIMIT = (32_768, 8_192)
P11_MIN_TIMIT_ACC = 0.9


def streamed_fit(dev, smi, classes=CLASSES, streams=P11_STREAMS, fit_images=P11_FIT_IMAGES,
                 held_out=P11_HELD_OUT, chunk=P11_CHUNK, vocab=P11_VOCAB, block=4096):
    """Phase 11a: the flagship's featurizer fit on ``fit_images`` images,
    then each stream of seeded images featurized chunk by chunk into
    ``Dataset.host_blocks_from_batches`` and the weighted solver fit from
    the host blocks; the peak device memory of each size, the host-block
    fit against the in-device one, the held-out top-5 error. Images are
    made on the card a chunk at a time, each chunk from its own seeded
    generator. To rehearse it on the CPU at a small size:
    ``streamed_fit(torch.device("cpu"), "cpu", classes=20, streams=(64, 128),
    fit_images=60, held_out=20, chunk=16, vocab=4, block=256)``."""
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    conf = flagship.ImageNetSiftLcsFVConfig(**dict(TRAIN_CONF, vocab_size=vocab, num_classes=classes))
    protos = imagenet_prototypes(classes, torch.Generator(device=dev).manual_seed(4321), dev)

    def images(start, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed * 10**7 + start)
        labels = torch.arange(start, start + n, device=dev) % classes
        return noisy_images(protos, labels, g), labels

    _reset_peak(dev)
    t = time.perf_counter()
    x_fit, _ = images(0, fit_images, seed=1)
    featurizer = flagship.build_featurizer(Dataset.from_array(x_fit), conf, device=dev).fit()
    sync()
    del x_fit
    rec = {"card": smi, "classes": classes, "vocab": vocab, "block": block, "chunk": chunk,
           "featurizer_fit_images": fit_images, "featurizer_fit_s": time.perf_counter() - t,
           "featurizer_fit_peak_bytes": _peak(dev), "streams": {}}
    log(f"11a featurizer (vocab {vocab}) fit on {fit_images} images in {rec['featurizer_fit_s']:.3f} s, "
        f"peak {rec['featurizer_fit_peak_bytes']} bytes on {smi}")

    def featurize(x):
        return featurizer(Dataset.from_array(x)).array()

    est = weighted_ls.BlockWeightedLeastSquaresEstimator(block, 1, conf.lam, conf.mixture_weight)
    for n in streams:
        _reset_peak(dev)
        _cuda.reset_launches()
        ys = []

        def batches():
            for s in range(0, n, chunk):
                x, y = images(s, min(chunk, n - s), seed=2)
                ys.append(y)
                yield featurize(x)

        t = time.perf_counter()
        host = Dataset.host_blocks_from_batches(batches(), block, device=dev)
        sync()
        feat_s = time.perf_counter() - t
        chunks = -(-n // chunk)
        run = {"images": n, "featurize_s": feat_s, "images_per_s": n / feat_s,
               "featurize_peak_bytes": _peak(dev), "launches": dict(_cuda.LAUNCHES),
               "launches_per_chunk": {k: v / chunks for k, v in _cuda.LAUNCHES.items()},
               "widths": host.block_widths[:1] + [len(host.block_widths)],
               "host_bytes": sum(b.nbytes for b in host.host_blocks)}
        labels = ClassLabelIndicators(classes).apply_batch(Dataset.from_array(torch.cat(ys)))
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        model = est.fit(host, labels)
        sync()
        run.update(solver_s=time.perf_counter() - t,
                   fit_peak_above_start_bytes=(torch.cuda.max_memory_allocated(dev) - base) if on_card else None,
                   cg_iterations=int(model.solver_info["pcg_iterations"]),
                   cg_exit_rel_residual=float(model.solver_info["pcg_max_rel_residual"]))
        rec["streams"][n] = run
        log(f"11a {n} images: featurized in {feat_s:.3f} s ({run['images_per_s']:.1f} images/s; "
            f"launches per chunk of {chunk} {run['launches_per_chunk']}; "
            f"{run['host_bytes']} bytes of host blocks, {len(host.block_widths)} of {block} columns; "
            f"featurize peak {run['featurize_peak_bytes']} bytes), weighted host-block fit in "
            f"{run['solver_s']:.3f} s ({run['cg_iterations']} CG iterations at most, exit residual "
            f"{run['cg_exit_rel_residual']:.3e}), fit peak above its start "
            f"{run['fit_peak_above_start_bytes']} bytes on {smi}")
        if on_card:
            for name in ("sift_bin_sample", "plane_sandwich", "fisher_vector_stats"):
                assert run["launches"][name] > 0, run["launches"]
        if n != streams[-1]:
            del host, labels, model

    # the growth of the fit's peak between the two sizes: the slabs and
    # the solver's (n, C) arrays, no term of n x D
    n0, n1 = streams
    D = sum(host.block_widths)
    if on_card:
        growth = rec["streams"][n1]["fit_peak_above_start_bytes"] - rec["streams"][n0]["fit_peak_above_start_bytes"]
        slabs = block_ls.SLABS_ON_CARD * (n1 - n0) * block * 4
        nc = (n1 - n0) * classes * 4
        rec["growth"] = {"bytes": growth, "slabs_bytes": slabs, "n_by_c_bytes": nc,
                         "n_by_c_arrays": (growth - slabs) / nc, "n_by_d_bytes": (n1 - n0) * D * 4}
        log(f"11a fit peak growth {n0} -> {n1} images: {growth} bytes = {slabs} bytes of "
            f"{block_ls.SLABS_ON_CARD} slabs + {rec['growth']['n_by_c_arrays']:.2f} (n x {classes}) "
            f"float32 arrays of {nc} bytes; the features would add {(n1 - n0) * D * 4} bytes")
        assert growth < 0.5 * (n1 - n0) * D * 4, rec["growth"]

    # the same features fit in device memory
    dense = torch.cat(host.host_blocks, dim=1).to(dev)
    sync()
    t = time.perf_counter()
    in_device = est.fit(Dataset.from_array(dense), labels)
    sync()
    del dense
    rel = {what: float(torch.linalg.vector_norm(getattr(model, what) - getattr(in_device, what))
                       / torch.linalg.vector_norm(getattr(in_device, what)))
           for what in ("W", "intercept")}
    rec["host_vs_device"] = {"rel_err": rel, "bar": RTOL_STREAM_FIT, "in_device_s": time.perf_counter() - t}
    log(f"11a host blocks vs in device memory, {n1} x {D}: ‖ΔW‖/‖W‖ {rel['W']:.3e}, ‖Δb‖/‖b‖ "
        f"{rel['intercept']:.3e} (bar {RTOL_STREAM_FIT}); in-device fit {rec['host_vs_device']['in_device_s']:.3f} s")
    assert max(rel.values()) <= RTOL_STREAM_FIT, rel
    del in_device

    # the fitted pipeline scores held-out images, one a class
    top = TopKClassifier(TOP_K)
    hits = []
    t = time.perf_counter()
    for s in range(0, held_out, chunk):
        x, y = images(s, min(chunk, held_out - s), seed=3)
        top5 = top.apply_batch(model.apply_batch(Dataset.from_array(featurize(x)))).array()
        hits.append((top5 == y[:, None]).any(dim=1))
    rec["top5_err"] = 1.0 - float(torch.cat(hits).float().mean())
    rec["held_out_s"] = time.perf_counter() - t
    log(f"11a held-out top-5 error {rec['top5_err']} on {held_out} images (limit {MAX_TOP5_ERR}), "
        f"{rec['held_out_s']:.3f} s")
    assert rec["top5_err"] <= MAX_TOP5_ERR, rec["top5_err"]
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def auto_cache_fit(dev, smi, classes=CLASSES, per_class=TRAIN_PER_CLASS):
    """Phase 11b: phase 6's fit under ``DefaultOptimizer`` and under
    ``AutoCachingOptimizer("greedy")``: the cache decision, each fit's time
    and peak, the solvers' W and the held-out top-5 of both. To rehearse it
    on the CPU: ``auto_cache_fit(torch.device("cpu"), "cpu", classes=50)``."""
    from keystone_tpu_torch.workflow import auto_cache
    from keystone_tpu_torch.workflow.optimizer import AutoCachingOptimizer, DefaultOptimizer

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    conf = flagship.ImageNetSiftLcsFVConfig(**dict(TRAIN_CONF, num_classes=classes))
    train_x, train_y, test_x, test_y = synthetic_imagenet(classes, per_class, seed=1234, dev=dev)
    env = PipelineEnv.get_or_create()
    rec, out = {"card": smi}, {}
    for name, opt in (("default", DefaultOptimizer()), ("auto_cache", AutoCachingOptimizer("greedy"))):
        _reset_peak(dev)
        env.optimizer = opt
        calls = {}
        try:
            with recorded(auto_cache.AutoCacheRule, "greedy_cache", sync, calls), \
                    recorded(auto_cache, "profile_nodes", sync, calls):
                t = time.perf_counter()
                fitted = flagship.build_pipeline(
                    Dataset.from_array(train_x), Dataset.from_array(train_y), conf, device=dev).fit()
                sync()
                fit_s = time.perf_counter() - t
                top5 = fitted(Dataset.from_array(test_x)).array()
        finally:
            env.reset()
        mapper = next(o for o in fitted.graph.operators.values() if isinstance(o, block_ls.BlockLinearMapper))
        out[name] = {"W": mapper.W, "top5": top5}
        r = {"fit_s": fit_s, "peak_bytes": _peak(dev),
             "top5_err": 1.0 - float((top5 == test_y[:, None]).any(dim=1).float().mean())}
        if "greedy_cache" in calls:
            _, graph, profiles, weights = calls["greedy_cache"]["args"]
            chosen = calls["greedy_cache"]["out"]
            r["profile_s"] = calls["profile_nodes"]["s"]
            r["decision"] = [{"node": n.id, "label": graph.operators[n].label,
                              "ms": profiles[n].ns / 1e6, "device_bytes": profiles[n].device_mem,
                              "weight": weights.get(n, 1)} for n in sorted(chosen)]
            r["profiled_nodes"] = len(profiles)
        rec[name] = r
        log(f"11b {name}: fit {fit_s:.3f} s, peak {r['peak_bytes']} bytes, held-out top-5 error "
            f"{r['top5_err']} on {smi}" + (f"; profiling {r['profile_s']:.3f} s over {r['profiled_nodes']} "
                                          f"nodes; caches {r['decision']}" if "decision" in r else ""))
    rec["top5_equal"] = bool(torch.equal(out["default"]["top5"], out["auto_cache"]["top5"]))
    rec["W_equal"] = bool(torch.equal(out["default"]["W"], out["auto_cache"]["W"]))
    dw = torch.linalg.vector_norm(out["default"]["W"] - out["auto_cache"]["W"])
    rec["W_rel_diff"] = float(dw / torch.linalg.vector_norm(out["default"]["W"]))
    log(f"11b held-out top-5 equal to the default fit's: {rec['top5_equal']}; solver W bit for bit "
        f"equal: {rec['W_equal']} (‖ΔW‖/‖W‖ {rec['W_rel_diff']:.3e})")
    assert rec["top5_equal"], rec
    return rec


def other_estimators(dev, smi, keep):
    """Phase 11c: ``PerClassWeightedLeastSquaresEstimator`` and the
    block-weighted solver on phase 9's VOC features, at the flagship's
    lambda and mixture weight; ``ApproximatePCAEstimator`` at the
    flagship's SIFT PCA shape (128 -> 64) on phase 6's descriptor sample,
    against the exact PCA, at the JAX defaults and at
    ``P11_POWER_ITERS`` power iterations, and at the JAX defaults on data
    with a spectral gap at 64. A row's class for the solvers is its first
    label; an image's prediction counts as right when its highest score is
    one of its labels (VOC images have 1 to 3). To rehearse it on the CPU,
    fill ``keep`` through phase 6's and phase 9's rehearsals, phase 9 at
    ``n_train=120`` (at 40 images, a class can be no image's first
    label, and the per-class solver then raises, as the JAX package's
    does)."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    rec = {"card": smi}
    X, Y = keep["voc_X"], keep["voc_Y"]
    first = torch.argmax(Y, dim=1)
    lam, w = TRAIN_CONF["lam"], TRAIN_CONF["mixture_weight"]
    for name, est in (("per_class", weighted_ls.PerClassWeightedLeastSquaresEstimator(4096, 1, lam, w)),
                      ("block_weighted", weighted_ls.BlockWeightedLeastSquaresEstimator(4096, 1, lam, w))):
        _reset_peak(dev)
        t = time.perf_counter()
        model = est.fit(Dataset.from_array(X), Dataset.from_array(Y))
        sync()
        fit_s = time.perf_counter() - t
        pred = torch.argmax(model.apply_batch(Dataset.from_array(X)).array(), dim=1)
        r = {"fit_s": fit_s, "peak_bytes": _peak(dev), "shape": list(X.shape) + [Y.shape[1]],
             "train_acc": float((Y[torch.arange(X.shape[0], device=X.device), pred] > 0).float().mean()),
             "train_acc_first_label": float((pred == first).float().mean())}
        rec[name] = r
        log(f"11c {name} on VOC features {r['shape']}: fit {fit_s:.3f} s, training argmax accuracy "
            f"{r['train_acc']:.4f} (bar {P11_MIN_TRAIN_ACC}; against the first label only "
            f"{r['train_acc_first_label']:.4f}), peak {r['peak_bytes']} bytes on {smi}")
        assert r["train_acc"] > P11_MIN_TRAIN_ACC, r

    # the sketch PCA at the flagship's SIFT PCA shape: on data with the
    # spectral gap of the JAX test's (rank 64 plus noise of 0.01) at the
    # JAX defaults, and on phase 6's descriptor sample at the defaults and
    # at P11_POWER_ITERS power iterations
    cols = pca.matrix_columns(keep["sift_pca_sample"])
    n, d = cols.array().shape
    dims = 64
    g = torch.Generator(device=dev).manual_seed(64)
    lowrank = (torch.randn(n, dims, device=dev, generator=g) @ torch.randn(dims, d, device=dev, generator=g)
               + 0.01 * torch.randn(n, d, device=dev, generator=g))
    rec["approximate_pca"] = {}
    for data_name, data, qs in (("rank 64 plus noise", Dataset.from_array(lowrank), (2,)),
                                ("SIFT descriptor sample", cols, (2, P11_POWER_ITERS))):
        A = data.array() - data.array().mean(dim=0)
        exact = pca.PCAEstimator(dims).fit(data).pca_mat
        for q in qs:
            sync()
            t = time.perf_counter()
            approx = pca.ApproximatePCAEstimator(dims, q=q).fit(data).pca_mat
            sync()
            r = {"s": time.perf_counter() - t, "input": [n, d], "dims": dims, "q": q,
                 "min_cosine": float(torch.linalg.svdvals(exact.T @ approx).min()),
                 "variance_ratio": float((torch.linalg.norm(A @ approx) / torch.linalg.norm(A @ exact)) ** 2),
                 "bar": P11_MIN_ANGLE if (data_name, q) in BARRED_SKETCHES else None}
            rec["approximate_pca"][f"{data_name}, q={q}"] = r
            log(f"11c ApproximatePCA on the {data_name} [{n}, {d}] -> {dims}, q = {q}: {r['s']:.3f} s, smallest "
                f"principal-angle cosine against the exact PCA {r['min_cosine']:.6f} (bar {r['bar']}), "
                f"variance captured against the exact PCA's {r['variance_ratio']:.6f}")
            if r["bar"] is not None:
                assert r["min_cosine"] > r["bar"], r
    return rec


def write_timit(root, X, y, name):
    """A TIMIT-layout feature CSV (values to two decimals, through a table
    of their strings) and its "row label" file, 1-based."""
    table = np.array([f"{v / 100:.2f}" for v in range(-5000, 5001)], dtype=object)
    q = np.clip(np.round(X * 100).astype(np.int64), -5000, 5000) + 5000
    feats, labels = os.path.join(root, f"{name}.csv"), os.path.join(root, f"{name}.labels")
    with open(feats, "w") as f:
        for s in range(0, len(q), 8192):
            f.write("\n".join(",".join(r) for r in table[q[s : s + 8192]]) + "\n")
    with open(labels, "w") as f:
        f.write("".join(f"{i + 1} {c + 1}\n" for i, c in enumerate(y)))
    return feats, labels


def timit_at_width(dev, smi, sizes=P11_TIMIT, flags=()):
    """Phase 11d: ``timit.main`` with the JAX defaults on TIMIT-layout files
    of seeded frames (class centres x 3 plus unit noise, 440 dimensions,
    147 classes) under the gitignored ``tmp/phase11``. To rehearse it on the
    CPU: ``timit_at_width(torch.device("cpu"), "cpu", sizes=(8192, 1024),
    flags=["--numCosines", "2", "--numEpochs", "1"])`` (more training frames
    than a block's 4,096 columns: below that, lambda 0 leaves each block's
    Gram singular)."""
    from keystone_tpu_torch.loaders.text_loaders import TIMIT_DIMENSION, TIMIT_NUM_CLASSES
    from keystone_tpu_torch.pipelines.speech import timit

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    root = os.path.join(ROOT, "tmp", "phase11")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n_train, n_test = sizes
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((TIMIT_NUM_CLASSES, TIMIT_DIMENSION)) * 3
    y = rng.integers(0, TIMIT_NUM_CLASSES, n_train + n_test)
    X = (centers[y] + rng.standard_normal((n_train + n_test, TIMIT_DIMENSION))).astype(np.float32)
    t = time.perf_counter()
    train = write_timit(root, X[:n_train], y[:n_train], "train")
    test = write_timit(root, X[n_train:], y[n_train:], "test")
    rec = {"card": smi, "train_frames": n_train, "test_frames": n_test, "write_s": time.perf_counter() - t,
           "bytes": os.path.getsize(train[0]) + os.path.getsize(test[0])}
    argv = ["--trainDataLocation", train[0], "--trainLabelsLocation", train[1],
            "--testDataLocation", test[0], "--testLabelsLocation", test[1], *flags]
    _reset_peak(dev)
    calls, times = {}, {}
    out = io.StringIO()
    with recorded(timit, "run", sync, calls), recorded(timit, "TimitFeaturesDataLoader", sync, calls), \
            node_times(sync, times, ["main"]), contextlib.redirect_stdout(out):
        t = time.perf_counter()
        rc = timit.main(argv, device=dev)
        rec["main_s"] = time.perf_counter() - t
    shutil.rmtree(root, ignore_errors=True)
    predictor, metrics = calls["run"]["out"]
    printed = out.getvalue().splitlines()
    assert rc == 0 and printed[-1].startswith("Total time: "), printed[-3:]
    # each branch node stands on the training path and the test path
    features = sum({id(o): o.W.shape[0] for o in predictor._graph.operators.values()
                    if type(o).__name__ == "CosineRandomFeatures"}.values())
    rec.update(accuracy=metrics.total_accuracy, features=features, peak_bytes=_peak(dev),
               load_s=calls["TimitFeaturesDataLoader"]["s"], run_s=calls["run"]["s"],
               node_times=times["main"], printed=[printed[0], printed[-1]])
    log(f"11d TIMIT main() on {n_train} + {n_test} frames ({rec['bytes']} bytes of CSV written in "
        f"{rec['write_s']:.3f} s): {rec['main_s']:.3f} s (loading {rec['load_s']:.3f}, run "
        f"{rec['run_s']:.3f}), {features} features, accuracy {rec['accuracy']:.4f} (bar "
        f"{P11_MIN_TIMIT_ACC}), peak {rec['peak_bytes']} bytes on {smi}; by node (s): {times['main']}")
    assert rec["accuracy"] > P11_MIN_TIMIT_ACC, rec["accuracy"]
    if not flags:  # the published width: 40 x 4,096 cosines
        assert features == timit.TimitConfig().num_cosines * timit.NUM_COSINE_FEATURES, features
    return rec


# phase 12: the text apps at their published widths (the JAX defaults:
# nGrams 2, commonFeatures 100,000; Newsgroups' 20 classes; Amazon's
# threshold 3.5 and numIters 20), in both feature modes, on seeded
# synthetic corpora in the loaders' formats, and the ELL solver at the
# Amazon experiment's shape (bench.py:232-259). Only corpus sizes are cut.
# 20 Newsgroups "bydate" (11,314 train, 7,532 test), halved since phase 19
P12_NEWS = (5_657, 3_766)
P12_NEWS_WORDS, P12_REVIEW_WORDS = 250, 100
# Amazon's reviews: a quarter of the earlier runs' 50,000 + 10,000
# string-keyed and 1,000,000 + 200,000 hashed (halved for phase 17, and
# again for phase 19)
P12_AMAZON, P12_AMAZON_HASHED = (12_500, 2_500), (250_000, 50_000)
# a Zipf vocabulary of 30,000 words; each word of a document is, with the
# given chance, one of its class's (or sentiment's) own words instead
P12_VOCAB, P12_ZIPF = 30_000, 1.07
P12_CLASS_WORDS, P12_CLASS_SHARE = 150, 0.1
P12_SENTIMENT_WORDS, P12_SENTIMENT_SHARE = 200, 0.05
P12_MIN_ACC = 0.9
# 12c: N, D, nnz, K and lambda of bench.py:232-259; G and AᵀY over a prefix
# of 1M rows (one tile, as the fit forms it) held against float64, as a
# share of the largest entry: the float32 accumulation of 1M exact bf16
# products on the tensor cores read 1.17e-5 for G (2.3e-7 for AᵀY) on an
# NVIDIA H100 80GB HBM3 at 700 W, above the 1e-5 first set here; a Gram
# whose partial sums were rounded to bf16 would stray by ~4e-3 (bf16's
# epsilon). The mapper against the dense float32 product (read 8.4e-8)
P12_ELL = dict(n=65_000_000, d=1024, nnz=5, k=2, lam=1e-2)
P12_ELL_CHECK_ROWS = 1_000_000
RTOL_ELL_GRAM, RTOL_ELL_APPLY = 1e-4, 1e-5
# 12b's logistic regression card against CPU on the string-keyed mode's
# training rows: ‖ΔW‖/‖W‖ and the share of equal training predictions
# (float32 sums in another order move the line search's trials a little)
RTOL_LR_W, MIN_LR_AGREE = 1e-3, 0.999
# H100 SXM data sheet, dense bf16 on the tensor cores
PEAK_BF16_FLOPS = 989e12


def _letters(v):
    """(v, 4) uint8: word ``i`` of the vocabulary is the four lowercase
    letters of ``i + 26³`` in base 26, so no two words are alike."""
    i = np.arange(v) + 26 ** 3
    return (97 + (i[:, None] // 26 ** np.arange(3, -1, -1)) % 26).astype(np.uint8)


def zipf_table(bits=22, zipf=P12_ZIPF):
    """Inverse-CDF table of a Zipf law over ``P12_VOCAB`` words: word ids
    at ``2**bits`` evenly spaced quantiles (a draw is one gather; the
    rarest word's share, 1.8e-6, spans several entries)."""
    p = 1.0 / np.arange(1, P12_VOCAB + 1) ** zipf
    q = (np.arange(2 ** bits) + 0.5) / 2 ** bits
    return np.minimum(np.searchsorted(np.cumsum(p / p.sum()), q), P12_VOCAB - 1).astype(np.int32)


def text_rows(rng, labels, words, extra, share, table):
    """One document per label as a row of ASCII bytes: ``words`` words
    drawn from the Zipf vocabulary of ``table``, each one with chance
    ``share`` replaced by one of ``extra[label]`` (the ids of a class's own
    words, past the shared vocabulary), space-separated, the first letter
    capitalized and a period at the end: (n, 5 · words) uint8."""
    n = len(labels)
    tok = table[rng.integers(0, table.size, (n, words), dtype=np.int64)]
    own = np.asarray(extra, np.int32)
    at = np.flatnonzero(rng.random(n * words, dtype=np.float32) < share)
    tok.reshape(-1)[at] = own[np.asarray(labels)[at // words], rng.integers(0, own.shape[1], at.size)]
    out = np.full((n, words, 5), ord(" "), np.uint8)
    out[:, :, :4] = _letters(P12_VOCAB + own.size)[tok]
    out = out.reshape(n, words * 5)
    out[:, -1] = ord(".")
    out[:, 0] -= 32  # capitalized
    return out


def _own_words(classes, per_class):
    return [list(range(P12_VOCAB + c * per_class, P12_VOCAB + (c + 1) * per_class))
            for c in range(classes)]


def write_newsgroups(root, rng, sizes=P12_NEWS, words=P12_NEWS_WORDS):
    """Train and test directories of per-class plaintext files (the
    loader's format), 20 classes, seeded."""
    from keystone_tpu_torch.loaders.text_loaders import NEWSGROUPS_CLASSES

    k = len(NEWSGROUPS_CLASSES)
    table = zipf_table()
    dirs = []
    for split, n in zip(("train", "test"), sizes):
        labels = rng.integers(0, k, n)
        rows = text_rows(rng, labels, words, _own_words(k, P12_CLASS_WORDS), P12_CLASS_SHARE,
                         table)
        for c in NEWSGROUPS_CLASSES:
            os.makedirs(os.path.join(root, split, c))
        for i, (row, c) in enumerate(zip(rows, labels)):
            with open(os.path.join(root, split, NEWSGROUPS_CLASSES[c], f"{i:06d}"), "wb") as f:
                f.write(row.tobytes())
        dirs.append(os.path.join(root, split))
    return dirs


def write_reviews(path, rng, n, words=P12_REVIEW_WORDS, chunk=200_000):
    """JSON lines with "overall" (1 to 5) and "reviewText", the loader's
    format, written a chunk of rows of bytes at a time: a review rated 4 or
    5 leans on positive words, 1 to 3 on negative ones."""
    head, tail = b'{"overall": 0.0, "reviewText": "', b'"}\n'
    digit = head.index(b"0")
    extra = _own_words(2, P12_SENTIMENT_WORDS)
    table = zipf_table()
    with open(path, "wb") as f:
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            positive = rng.random(m) < 0.5
            ratings = np.where(positive, rng.integers(4, 6, m), rng.integers(1, 4, m))
            text = text_rows(rng, positive.astype(np.int64), words, extra, P12_SENTIMENT_SHARE,
                             table)
            line = np.empty((m, len(head) + text.shape[1] + len(tail)), np.uint8)
            line[:, : len(head)] = np.frombuffer(head, np.uint8)
            line[:, digit] = ord("0") + ratings
            line[:, len(head) : len(head) + text.shape[1]] = text
            line[:, -len(tail):] = np.frombuffer(tail, np.uint8)
            line.tofile(f)
    return path


def _only_node(predictor, name):
    (node,) = {id(o): o for o in predictor._graph.operators.values()
               if type(o).__name__ == name}.values()
    return node


def _csr_bytes(a):
    return a.crow_indices().numel() * 8 + a._nnz() * (8 + 4)


def text_app(dev, app, argv, sync, check_cpu):
    """One text app's ``main(argv)`` on ``dev``: its printed metrics, the
    time split by node, the fit's records, the peak device memory, and the
    fitted estimator's inputs, held against a CPU fit when ``check_cpu``;
    Naive Bayes' test predictions under ``"predictions"``."""
    from keystone_tpu_torch.ops.learning import classifiers
    from keystone_tpu_torch.ops.util.nodes import CommonSparseFeatures, MaxClassifier

    est_name = "NaiveBayesEstimator" if app.__name__.endswith("newsgroups") else \
        "LogisticRegressionEstimator"
    est_cls = getattr(classifiers, est_name)
    calls, times, vec, scored = {}, {}, {}, {}
    out = io.StringIO()
    _reset_peak(dev)
    with recorded(app, "run", sync, calls), recorded(est_cls, "fit", sync, calls), \
            recorded(CommonSparseFeatures, "fit", sync, vec), \
            recorded(MaxClassifier, "apply_batch", sync, scored), \
            node_times(sync, times, ["main"]), contextlib.redirect_stdout(out):
        t = time.perf_counter()
        rc = app.main(argv, device=dev)
        main_s = time.perf_counter() - t
    assert rc == 0, rc
    predictor, metrics = calls["run"]["out"]
    est, data, labels = calls["fit"]["args"]
    x = data.to_array_mode().padded()
    rec = {"main_s": main_s, "run_s": calls["run"]["s"], "fit_s": calls["fit"]["s"],
           "peak_bytes": _peak(dev), "node_times": times["main"], "rows": x.shape[0],
           "features": x.shape[1], "nnz": x._nnz(), "csr_bytes": _csr_bytes(x),
           "printed": out.getvalue().splitlines()[:3]}
    if est_name == "NaiveBayesEstimator":
        rec["accuracy"] = metrics.total_accuracy
        rec["predictions"] = scored["apply_batch"]["out"].array()  # the test split's
    else:
        rec["accuracy"] = metrics.accuracy
        rec["lbfgs"] = dict(est.fit_stats)
    if "--hashing" in argv:
        routes = _only_node(predictor, "FusedTextHashTF").routes
        rec["routes"] = dict(routes)
        # the corpora are ASCII: every document must take the native path
        assert routes["native"] > 0 and routes["python"] == 0, routes
    else:
        rec["common_features"] = len(vec["fit"]["out"].feature_index)
    if check_cpu:
        x_cpu = Dataset.from_array(x.cpu(), n=data.n)
        y_cpu = Dataset.from_array(labels.to_array_mode().array().cpu())
        card = calls["fit"]["out"]
        if est_name == "NaiveBayesEstimator":
            host = classifiers.NaiveBayesEstimator(est.num_classes, est.lam).fit(x_cpu, y_cpu)
            for name in ("pi", "theta"):
                err = max_abs_err(getattr(card, name).cpu(), getattr(host, name), 1e-5, 1e-6,
                                  f"12a Naive Bayes {name}, card vs CPU")
                rec[f"{name}_max_abs_err"] = err
        else:
            host = classifiers.LogisticRegressionEstimator(
                est.num_classes, num_iters=est.num_iters).fit(x_cpu, y_cpu)
            rel = float(torch.linalg.norm(card.W.cpu() - host.W) / torch.linalg.norm(host.W))
            agree = int((card.apply_batch(x_cpu).array().cpu()
                         == host.apply_batch(x_cpu).array()).sum()) / x_cpu.n
            rec.update(w_rel_err=rel, train_agreement=agree)
            assert rel <= RTOL_LR_W and agree >= MIN_LR_AGREE, (rel, agree)
    return rec, predictor


def text_apps(dev, smi, news=P12_NEWS, amazon=P12_AMAZON, hashed=P12_AMAZON_HASHED,
              ell=P12_ELL, check_rows=P12_ELL_CHECK_ROWS):
    """Phase 12: NewsgroupsPipeline and AmazonReviewsPipeline ``main()`` at
    the JAX defaults in both feature modes on seeded corpora written under
    the gitignored ``tmp/phase12`` (12a, 12b), and
    ``EllLeastSquaresEstimator`` at 65M x 1,024 (12c). To rehearse it on
    the CPU at a small size: ``text_apps(torch.device("cpu"), "cpu",
    news=(2000, 500), amazon=(2000, 500), hashed=(4000, 500),
    ell=dict(n=20_000, d=64, nnz=5, k=2, lam=1e-2), check_rows=5_000)``
    (about 20 s)."""
    from keystone_tpu_torch.loaders.text_loaders import NewsgroupsDataLoader
    from keystone_tpu_torch.ops.learning import sparse_ell
    from keystone_tpu_torch.pipelines.text import amazon_reviews, newsgroups
    from keystone_tpu_torch.workflow.api import FittedPipeline

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    root = os.path.join(ROOT, "tmp", "phase12")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(12)
    rec = {"card": smi, "host_cpus": os.cpu_count(), "usable_cpus": len(os.sched_getaffinity(0))}
    log(f"phase 12 host: {rec['host_cpus']} CPUs, {rec['usable_cpus']} usable by this process")

    # -- 12a: NewsgroupsPipeline -------------------------------------------
    t = time.perf_counter()
    train_dir, test_dir = write_newsgroups(root, rng, news)
    rec["news_write_s"] = time.perf_counter() - t
    argv = ["--trainLocation", train_dir, "--testLocation", test_dir]
    for mode, flags in (("strings", []), ("hashing", ["--hashing"])):
        r, predictor = text_app(dev, newsgroups, argv + flags, sync, check_cpu=True)
        assert r["accuracy"] > P12_MIN_ACC, r["accuracy"]
        if mode == "strings":
            assert r["common_features"] == 100_000
            # the fitted pipeline through a file, then the test split again:
            # the predictions main() made, bit for bit
            t = time.perf_counter()
            fitted = predictor.fit()
            path = os.path.join(root, "newsgroups.pt")
            fitted.save(path)
            loaded = FittedPipeline.load(path, device=dev)
            got = loaded(NewsgroupsDataLoader(test_dir).data).array()
            sync()
            assert torch.equal(got, r.pop("predictions")), "a reloaded pipeline scores otherwise"
            r.update(saved_bytes=os.path.getsize(path), reload_score_s=time.perf_counter() - t)
            del fitted, loaded
        r.pop("predictions", None)
        rec[f"news_{mode}"] = r
        log(f"12a Newsgroups main() {mode} on {news[0]} + {news[1]} documents: "
            f"{r['main_s']:.3f} s, accuracy {r['accuracy']:.4f}, {r['nnz']} nonzeros "
            f"({r['csr_bytes']} bytes of CSR), peak {r['peak_bytes']} bytes on {smi}; "
            f"by node (s): {r['node_times']}" + (f"; routes {r['routes']}" if "routes" in r else
                                                 f"; saved {r['saved_bytes']} bytes, reloaded "
                                                 f"and scored bit for bit in {r['reload_score_s']:.3f} s"))
    shutil.rmtree(os.path.join(root, "train"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "test"), ignore_errors=True)

    # -- 12b: AmazonReviewsPipeline ----------------------------------------
    for mode, sizes, flags in (("strings", amazon, []), ("hashing", hashed, ["--hashing"])):
        t = time.perf_counter()
        train = write_reviews(os.path.join(root, "train.json"), rng, sizes[0])
        test = write_reviews(os.path.join(root, "test.json"), rng, sizes[1])
        write_s = time.perf_counter() - t
        r, _ = text_app(dev, amazon_reviews, ["--trainLocation", train, "--testLocation", test]
                        + flags, sync, check_cpu=mode == "strings")
        r.update(write_s=write_s, sizes=sizes,
                 card_bytes_with_transpose=2 * r["csr_bytes"])
        assert r["accuracy"] > P12_MIN_ACC, r["accuracy"]
        rec[f"amazon_{mode}"] = r
        log(f"12b Amazon main() {mode} on {sizes[0]} + {sizes[1]} reviews (written in {write_s:.3f} "
            f"s): {r['main_s']:.3f} s, accuracy {r['accuracy']:.4f}, L-BFGS {r['lbfgs']}, "
            f"{r['nnz']} nonzeros ({r['csr_bytes']} bytes of CSR, twice that with its "
            f"transpose), fit {r['fit_s']:.3f} s, peak {r['peak_bytes']} bytes on {smi}; by node "
            f"(s): {r['node_times']}" + (f"; routes {r['routes']}" if "routes" in r else
                                         f"; card vs CPU: W {r['w_rel_err']:.3g}, training "
                                         f"predictions equal {r['train_agreement']:.5f}"))
        os.remove(train)
        os.remove(test)

    # -- 12c: the ELL solver at 65M x 1,024 ---------------------------------
    _reset_peak(dev)
    n, d, nnz, k = ell["n"], ell["d"], ell["nnz"], ell["k"]
    g = torch.Generator(device=dev).manual_seed(12)
    t = time.perf_counter()
    idx = torch.randint(0, d, (n, nnz), generator=g, device=dev, dtype=torch.int32)
    vals = torch.randn((n, nnz), generator=g, device=dev, dtype=torch.bfloat16)
    Y = torch.randn((n, k), generator=g, device=dev, dtype=torch.bfloat16)
    sync()
    gen_s = time.perf_counter() - t
    est = sparse_ell.EllLeastSquaresEstimator(d=d, lam=ell["lam"])
    data, labels = sparse_ell.ell_dataset(idx, vals), Dataset.from_array(Y)
    chunk = min(est.chunk, n)
    seg = max(int(est.segment_flops / (2.0 * d * d)) // chunk, 1) * chunk
    segments = -(-n // seg)
    fits = []
    for _ in range(2):  # the first fit pays cuBLAS's first-call setup
        sync()
        t = time.perf_counter()
        model = est.fit(data, labels)
        sync()
        fits.append(time.perf_counter() - t)
    flop = 2.0 * n * d * (d + k)
    rec["ell"] = er = {"n": n, "d": d, "nnz": nnz, "k": k, "gen_s": gen_s, "fit_s": fits,
                       "segments": segments, "flop": flop, "tflops": flop / min(fits) / 1e12,
                       "bound_s": flop / PEAK_BF16_FLOPS, "peak_bytes": _peak(dev),
                       "data_bytes": idx.numel() * 4 + vals.numel() * 2 + Y.numel() * 2}
    assert bool(torch.isfinite(model.W).all())
    # G and AᵀY of a prefix against float64 from the same bf16 tile
    rows = min(check_rows, n)
    G, AY = sparse_ell._normal_eq_pass(idx[:rows], vals[:rows], Y[:rows], d=d, chunk=rows)
    tile = sparse_ell.ell_to_dense(idx[:rows], vals[:rows], d).to(torch.float64)
    G64, AY64 = tile.T @ tile, tile.T @ Y[:rows].to(torch.float64)
    del tile
    er["gram_rel_err"] = float((G.double() - G64).abs().max() / G64.abs().max())
    er["aty_rel_err"] = float((AY.double() - AY64).abs().max() / AY64.abs().max())
    # the mapper's gather against the dense float32 product (duplicate ids
    # summed in float32 here, as the gather sums them)
    dense = torch.zeros((rows, d), dtype=torch.float32, device=dev)
    dense.scatter_add_(1, idx[:rows].to(torch.int64), vals[:rows].to(torch.float32))
    want = dense @ model.W
    got = model.apply_batch(sparse_ell.ell_dataset(idx[:rows], vals[:rows])).array()
    er["apply_rel_err"] = float((got - want).abs().max() / want.abs().max())
    del dense, want, got, G, AY, G64, AY64
    log(f"12c EllLeastSquaresEstimator at {n} x {d}, nnz {nnz}, K {k} ({er['data_bytes']} bytes "
        f"made in {gen_s:.3f} s): fits {[round(f, 4) for f in fits]} s, {er['tflops']:.1f} TFLOP/s "
        f"of Gram (bound {er['bound_s']:.4f} s at the bf16 peak), {segments} segment(s), peak "
        f"{er['peak_bytes']} bytes; over {rows} rows G {er['gram_rel_err']:.3g} and AᵀY "
        f"{er['aty_rel_err']:.3g} of the largest float64 entry, the mapper "
        f"{er['apply_rel_err']:.3g} of the dense product, on {smi}")
    assert er["gram_rel_err"] <= RTOL_ELL_GRAM and er["aty_rel_err"] <= RTOL_ELL_GRAM, er
    assert er["apply_rel_err"] <= RTOL_ELL_APPLY, er
    del idx, vals, Y, data, labels, model
    PipelineEnv.get_or_create().reset()
    shutil.rmtree(root, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# phase 13: the last app and the remaining operators (no kernel of this repo)
# 13a: StupidBackoffPipeline on a seeded Zipf corpus of P13_SB lines of
# P13_SB_WORDS words over P13_SB_VOCAB words (under 2^20, so the bit-packing
# indexer takes every id); 1,000 sampled n-grams held against a direct count;
# 20,000 lines since phase 19 (40,000 before)
P13_SB, P13_SB_WORDS, P13_SB_VOCAB, P13_SB_CHECK = 20_000, 20, 200_000, 1_000
# 13b: CoNLL-2003 English train's shape (sentences, tokens, longest
# sentence) and testb's sentence count; the NER tagger fit for a quarter
# of the JAX default's 200 epochs and WSJ's 45 POS tags for 25 (the
# script's time: 200 and 100 before phase 19)
P13_CONLL, P13_CONLL_TEST = (14_041, 203_621, 113), 3_453
P13_NER_EPOCHS, P13_POS_TAGS, P13_POS_EPOCHS = 50, 45, 25
P13_PARITY_ROWS, P13_PARITY_EPOCHS = 512, 5
# the CRF's parameters after P13_PARITY_EPOCHS epochs, card against the CPU:
# the largest entry difference and ‖Δ‖/‖CPU‖ (float32 sums in other orders
# through five Adam steps; the CPU port against JAX read 2e-5 at most,
# tests/test_torch_nlp_models.py)
ATOL_CRF_CARD, RTOL_CRF_CARD_NORM = 1e-3, 1e-4
# the JAX tests' bars for a trained NER tagger (tests/ops/test_crf.py)
P13_MIN_NER_ACC, P13_NER_OVER_RULE = 0.9, 0.15
# 13c: VOC's usual image size, a batch of them, and a mixed-size batch
P13_IMG, P13_IMAGES = (500, 375), 64
P13_MIXED = ((500, 375), (375, 500), (500, 333), (333, 500))
# 13d: gram and qr_q at 1,048,576 x 1,024 float32 (4.3 GB); gram against
# float64 on the first P13_CHECK_ROWS rows
P13_QR, P13_CHECK_ROWS = (1 << 20, 1024), 65_536
MAX_ORTHO_ERR, RTOL_QR, RTOL_GRAM = 1e-3, 1e-5, 1e-5


def zipf_corpus(rng, lines, words, vocab):
    """(lines, words) word ids of a Zipf law over ``vocab`` words."""
    p = 1.0 / np.arange(1, vocab + 1) ** 1.05
    cdf = np.cumsum(p / p.sum())
    ids = np.searchsorted(cdf, rng.random((lines, words)))
    return np.minimum(ids, vocab - 1)


def stupid_backoff_app(dev, smi, root, lines=P13_SB, words=P13_SB_WORDS, vocab=P13_SB_VOCAB,
                       checks=P13_SB_CHECK):
    """13a: ``main()`` and ``python -m keystone_tpu_torch StupidBackoffPipeline``
    on a written corpus; sampled scores against a direct count."""
    from keystone_tpu_torch.ops.nlp import NaiveBitPackIndexer
    from keystone_tpu_torch.pipelines.nlp import stupid_backoff_pipeline as sbp

    rng = np.random.default_rng(13)
    t = time.perf_counter()
    ids = zipf_corpus(rng, lines, words, vocab)
    text = _letters(vocab)[ids]  # (lines, words, 4) letters
    rows = np.full((lines, words, 5), ord(" "), np.uint8)
    rows[:, :, :4] = text
    rows[:, -1, 4] = ord("\n")
    path = os.path.join(root, "corpus.txt")
    with open(path, "wb") as f:
        f.write(rows.tobytes())
    rec = {"lines": lines, "tokens": lines * words, "write_s": time.perf_counter() - t}
    calls = {}
    out = io.StringIO()
    with recorded(sbp, "run", lambda: None, calls), contextlib.redirect_stdout(out):
        t = time.perf_counter()
        assert sbp.main(["--trainLocation", path]) == 0
        rec["main_s"] = time.perf_counter() - t
    printed = out.getvalue()
    model, encoder = calls["run"]["out"]
    rec.update(printed=printed.strip(), ngrams=len(model.ngram_counts), vocab=len(encoder.word_index))
    # the bit-packing indexer takes every id of this vocabulary
    top = max(encoder.word_index.values())
    packer = NaiveBitPackIndexer()
    assert [packer.unpack(packer.pack([top, top, top]), i) for i in range(3)] == [top] * 3

    # the direct count, on the word ids the corpus was written from: each
    # word's rank is the encoder's; counts of every bigram and trigram
    rank = np.full(vocab, -1, np.int64)
    words_seen = np.unique(ids)
    spelled = _letters(vocab)
    rank[words_seen] = [encoder.word_index[spelled[w].tobytes().decode()] for w in words_seen]
    r = rank[ids]
    assert (r >= 0).all()
    V = np.int64(len(encoder.word_index))
    uni = np.bincount(r.reshape(-1), minlength=int(V))
    bi_keys, bi_counts = np.unique((r[:, :-1] * V + r[:, 1:]).reshape(-1), return_counts=True)
    tri_keys, tri_counts = np.unique(((r[:, :-2] * V + r[:, 1:-1]) * V + r[:, 2:]).reshape(-1),
                                     return_counts=True)
    bi, tri = dict(zip(bi_keys.tolist(), bi_counts.tolist())), dict(zip(tri_keys.tolist(),
                                                                        tri_counts.tolist()))
    n_tokens = int(uni.sum())
    assert model.num_tokens == n_tokens

    def direct(g):
        if len(g) == 3:
            c = tri.get((g[0] * V + g[1]) * V + g[2], 0)
            if c:
                return c / bi[g[0] * V + g[1]]
            return 0.4 * direct(g[1:])
        c = bi.get(g[0] * V + g[1], 0)
        if c:
            return c / uni[g[0]]
        return 0.4 * uni[g[1]] / n_tokens

    seen = list(model.ngram_counts)
    picks = [seen[i] for i in rng.choice(len(seen), checks // 2, replace=False)]
    # unseen n-grams that back off once or twice, over words of the corpus
    picks += [tuple(int(x) for x in rng.choice(int(V), k)) for k in (2, 3) for _ in range(checks // 4)]
    worst = 0.0
    for g in picks:
        got, want = model.score(g), direct(g)
        assert abs(got - want) <= 1e-12 * max(abs(want), 1e-300), (g, got, want)
        worst = max(worst, abs(got - want))
    rec.update(checked=len(picks), max_abs_err=worst)
    # the run-pipeline entry in a fresh process prints what main() printed
    t = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "keystone_tpu_torch", "StupidBackoffPipeline",
                          "--trainLocation", path], capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    rec["cli_s"] = time.perf_counter() - t
    assert cli.returncode == 0, cli.stderr[-2000:]
    assert cli.stdout == printed, (cli.stdout, printed)
    os.remove(path)
    log(f"13a StupidBackoffPipeline main() on {lines} lines, {rec['tokens']} tokens "
        f"({rec['vocab']} words, {rec['ngrams']} distinct 2- and 3-grams): {rec['main_s']:.3f} s; "
        f"{rec['checked']} sampled scores equal the direct count; `python -m keystone_tpu_torch "
        f"StupidBackoffPipeline` exited 0 in {rec['cli_s']:.3f} s and printed {printed.strip()!r}")
    return rec


def _lengths(rng, n, total, longest):
    """``n`` sentence lengths in [1, longest], one of them ``longest``,
    summing to ``total`` (a lognormal spread about the mean, then nudged)."""
    mean = total / n
    lens = np.clip(np.round(rng.lognormal(np.log(mean) - 0.18, 0.6, n)), 1, longest).astype(np.int64)
    lens[0] = longest
    while lens.sum() != total:
        diff = int(total - lens.sum())
        i = rng.integers(1, n, abs(diff))
        np.add.at(lens, i, np.sign(diff))
        lens[1:] = np.clip(lens[1:], 1, longest - 1)
    return lens


def _names(rng, count, offset, max_len=3):
    """Capitalized pseudo-word names of 1 to ``max_len`` tokens."""
    letters = _letters(offset + 4 * count)
    out = []
    for i in range(count):
        k = int(rng.integers(1, max_len + 1))
        out.append([letters[offset + 4 * i + j].tobytes().decode().capitalize() for j in range(k)])
    return out


def conll_like(rng, splits):
    """Seeded BIO-tagged sentences of CoNLL-2003's shape, one list per
    (sentences, tokens, longest) split: four entity types drawn from
    gazetteers (a fifth of the names shared by LOC and ORG, so context
    decides; the first split draws from four fifths of each gazetteer, so
    later splits hold unseen names), each with cue words before and
    after; lowercase Zipf fillers; entities capitalized, as in the data."""
    types = ("PER", "ORG", "LOC", "MISC")
    gaz = {t: _names(rng, 400, 20_000 + 2_000 * i) for i, t in enumerate(types)}
    gaz["ORG"][:80] = gaz["LOC"][:80]
    before = {"PER": ["minister", "coach", "striker", "president"], "ORG": ["club", "firm", "bank"],
              "LOC": ["in", "at", "near", "from"], "MISC": ["the", "a", "several"]}
    after = {"PER": ["said", "told"], "ORG": ["reported", "shares"], "LOC": ["hosted", "police"],
             "MISC": ["fans", "league"]}
    filler = [w.tobytes().decode() for w in _letters(5_000)]
    out = []
    for k, (n, total, longest) in enumerate(splits):
        names = 320 if k == 0 else 400
        fid = zipf_corpus(rng, 1, total, len(filler))[0]
        sents, at = [], 0
        for L in _lengths(rng, n, total, longest):
            toks, tags = [], []
            while len(toks) < L:
                if rng.random() < 0.22:
                    t = types[int(rng.integers(0, 4))]
                    if rng.random() < 0.7 and len(toks) + 2 <= L:
                        toks.append(before[t][int(rng.integers(0, len(before[t])))])
                        tags.append("O")
                    name = gaz[t][int(rng.integers(0, names))][: L - len(toks)]
                    toks += name
                    tags += ["B-" + t] + ["I-" + t] * (len(name) - 1)
                    if rng.random() < 0.5 and len(toks) < L:
                        toks.append(after[t][int(rng.integers(0, len(after[t])))])
                        tags.append("O")
                else:
                    toks.append(filler[fid[at % total]])
                    tags.append("O")
                    at += 1
            if tags[0] == "O":
                toks[0] = toks[0].capitalize()
            sents.append((toks, tags))
        out.append(sents)
    return out


def wsj_like(rng, splits, n_tags=P13_POS_TAGS):
    """Seeded POS-tagged sentences, one list per (sentences, tokens,
    longest) split, from one hidden Markov model over ``n_tags`` tags:
    sparse random transitions, a vocabulary of its own per tag, a fifth of
    each tag's words shared with the next tag's (so context decides)."""
    tags = [f"T{i:02d}" for i in range(n_tags)]
    trans = rng.dirichlet(np.full(n_tags, 0.08), n_tags)
    letters = _letters(60_000 + 400 * n_tags)
    vocab = []
    for i in range(n_tags):
        size = int(rng.integers(20, 400))
        lo = 60_000 + 400 * i
        vocab.append([w.tobytes().decode() for w in letters[lo : lo + size]])
    for i in range(n_tags):
        nxt = vocab[(i + 1) % n_tags]
        vocab[i] += nxt[: max(len(nxt) // 5, 1)]
    out = []
    for n, total, longest in splits:
        sents = []
        for L in _lengths(rng, n, total, longest):
            t = int(rng.integers(0, n_tags))
            toks, tg = [], []
            for _ in range(L):
                toks.append(vocab[t][int(rng.integers(0, len(vocab[t])))])
                tg.append(tags[t])
                t = int(rng.choice(n_tags, p=trans[t]))
            sents.append((toks, tg))
        out.append(sents)
    return out


def _token_acc(pred, sents):
    ok = sum(p == g for ps, (_, gs) in zip(pred, sents) for p, g in zip(ps, gs))
    return ok / sum(len(g) for _, g in sents)


def _bio_valid(tags):
    prev = "O"
    for t in tags:
        if t.startswith("I-") and prev not in {"B-" + t[2:], "I-" + t[2:]}:
            return False
        prev = t
    return True


def _rule_bio(tokens):
    """``rule_ner_tag`` on the BIO scheme, as the JAX package's tagging test
    maps it (PERSON -> PER, ORG and ENTITY -> ORG)."""
    from keystone_tpu_torch.ops.nlp import rule_ner_tag

    kind = {"PERSON": "PER", "ORG": "ORG", "ENTITY": "ORG"}
    out, prev = [], "O"
    for t in rule_ner_tag(tokens):
        k = kind.get(t)
        out.append("O" if k is None else ("I-" if prev == t else "B-") + k)
        prev = t
    return out


def _profile_step(step, dev, top=6):
    """One call of ``step`` under ``device_profile``: its kernels, their
    device ms, and the ``top`` kernel names by device time."""
    with device_profile() as prof:
        step()
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.function_events if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:90]] += e.device_time / 1e3
    return {"kernels": len(kernels), "device_ms": sum(by_name.values()),
            "top_ms": [[name, ms] for name, ms in by_name.most_common(top)]}


def crf_step_times(dev, sentences, feature_fn, constrain_bio, steps=20):
    """One training step of CRFNEREstimator's defaults on ``sentences``,
    eager against a CUDA graph replay: ms a step, each over ``steps``
    steps with one sync at the end, and one step of each by kernel."""
    from keystone_tpu_torch.ops.nlp import crf

    est = crf.CRFNEREstimator()
    _, idx, tags, mask, tmask, smask = crf._prepare(sentences, feature_fn, est.hash_dim,
                                                    constrain_bio)
    tr = crf._CRFTrainer(idx, tags, mask, tmask, smask, est.hash_dim, est.lr, est.l2,
                         est.batch_size, 2 * steps + crf._WARM_STEPS + 2, dev)
    tr.sel.copy_(torch.randperm(len(idx), device=dev)[: est.batch_size])
    out = {}
    for mode in ("eager", "graph"):
        if mode == "graph":
            tr.capture()
        else:
            for _ in range(crf._WARM_STEPS):
                tr.step()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(steps):
            tr.step()
        torch.cuda.synchronize(dev)
        out[f"{mode}_ms"] = (time.perf_counter() - t) / steps * 1e3
        out[f"{mode}_profile"] = _profile_step(tr.step, dev)
    out["capture_s"] = tr.capture_s
    assert bool(torch.isfinite(tr.losses).all())
    return out


def crf_taggers(dev, smi, conll=P13_CONLL, conll_test=P13_CONLL_TEST, parity_rows=P13_PARITY_ROWS,
                n_epochs=P13_NER_EPOCHS, pos_epochs=P13_POS_EPOCHS):
    """13b: CRF NER at CoNLL-2003 train's shape for ``n_epochs``, then the
    POS tagger at 45 tags for ``pos_epochs``; parameters card vs CPU on a
    slice."""
    from keystone_tpu_torch.ops.nlp import CRFNEREstimator, CRFTaggerEstimator, crf
    from keystone_tpu_torch.ops.nlp.tagging import _emit_features, _emit_ner_features

    n, total, longest = conll
    # testb's sentences at train's mean length
    test_split = (conll_test, int(round(total * conll_test / n)), longest)
    t = time.perf_counter()
    train, test = conll_like(np.random.default_rng(131), [conll, test_split])
    rec = {"sentences": n, "tokens": sum(len(s) for s, _ in train),
           "longest": max(len(s) for s, _ in train), "test_sentences": len(test),
           "gen_s": time.perf_counter() - t}
    assert rec["tokens"] == total and rec["longest"] == longest
    data = Dataset.from_items(train)

    if dev.type == "cuda":
        rec["ner_step"] = crf_step_times(dev, train, _emit_ner_features, True)
        st = rec["ner_step"]
        log(f"13b CRF NER training step, batch 1024 x {longest} steps: eager "
            f"{st['eager_ms']:.3f} ms, CUDA graph {st['graph_ms']:.3f} ms (captured in "
            f"{st['capture_s']:.3f} s); a replayed step's {st['graph_profile']['kernels']} kernels "
            f"take {st['graph_profile']['device_ms']:.3f} ms on the card, the most "
            f"{st['graph_profile']['top_ms'][:3]}, on {smi}")

    t = time.perf_counter()
    ner = CRFNEREstimator(n_epochs=n_epochs, device=dev).fit(data)
    rec["ner_fit_s"] = time.perf_counter() - t
    st = dict(ner.fit_stats)
    st["steps_per_s"] = st["steps"] / st["train_s"]
    rec["ner_fit"] = st
    t = time.perf_counter()
    pred = ner.decode([s for s, _ in test])
    rec["ner_decode_s"] = time.perf_counter() - t
    rec["ner_decode_per_s"] = len(test) / rec["ner_decode_s"]
    t = time.perf_counter()
    one = [ner(s) for s, _ in test[:200]]
    rec["ner_decode_one_per_s"] = 200 / (time.perf_counter() - t)
    assert one == pred[:200], "one-sentence decode differs from the batched decode"
    rec["ner_acc"] = _token_acc(pred, test)
    rec["rule_acc"] = _token_acc([_rule_bio(s) for s, _ in test], test)
    rec["ner_bio_invalid"] = sum(not _bio_valid(p) for p in pred)
    log(f"13b CRF NER fit on {n} sentences, {total} tokens (longest {longest}): "
        f"{rec['ner_fit_s']:.3f} s ({st['encode_s']:.3f} s encoding), {st['epochs']} epochs, "
        f"{st['steps']} steps at {st['steps_per_s']:.1f} steps/s (graph {st['graph']}); decode "
        f"{rec['ner_decode_per_s']:.1f} sentences/s batched, {rec['ner_decode_one_per_s']:.1f} one "
        f"at a time; token accuracy {rec['ner_acc']:.4f} (rule_ner_tag {rec['rule_acc']:.4f}), "
        f"{rec['ner_bio_invalid']} BIO-invalid paths of {len(test)} on {smi}")
    assert rec["ner_bio_invalid"] == 0
    assert rec["ner_acc"] > P13_MIN_NER_ACC and rec["ner_acc"] > rec["rule_acc"] + P13_NER_OVER_RULE, rec

    # parameters after a few epochs on a slice, card against the port on the CPU
    part = Dataset.from_items(train[:parity_rows])
    card = CRFNEREstimator(n_epochs=P13_PARITY_EPOCHS, device=dev).fit(part)
    host = CRFNEREstimator(n_epochs=P13_PARITY_EPOCHS, device="cpu").fit(part)
    par = {}
    for name in ("emit", "trans", "start"):
        a, b = getattr(card, name), getattr(host, name)
        ok = np.abs(b) < 1e8  # the folded -1e9 BIO masks are equal
        assert np.array_equal(a[~ok], b[~ok]), name
        par[name] = {"max_abs_err": float(np.abs(a[ok] - b[ok]).max()),
                     "rel_norm": float(np.linalg.norm(a[ok] - b[ok]) / np.linalg.norm(b[ok]))}
    rec["parity"] = par
    log(f"13b CRF NER parameters after {P13_PARITY_EPOCHS} epochs on {parity_rows} sentences, "
        f"card vs CPU: {par}")
    for name, p in par.items():
        assert p["max_abs_err"] <= ATOL_CRF_CARD and p["rel_norm"] <= RTOL_CRF_CARD_NORM, (name, p)

    # the POS tagger at WSJ's 45 tags, same shape
    t = time.perf_counter()
    ptrain, ptest = wsj_like(np.random.default_rng(133), [conll, test_split])
    rec["pos_gen_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pos = CRFTaggerEstimator(n_epochs=pos_epochs, device=dev).fit(Dataset.from_items(ptrain))
    rec["pos_fit_s"] = time.perf_counter() - t
    pst = dict(pos.fit_stats)
    pst["steps_per_s"] = pst["steps"] / pst["train_s"]
    rec["pos_fit"] = pst
    t = time.perf_counter()
    ppred = pos.decode([s for s, _ in ptest])
    rec["pos_decode_per_s"] = len(ptest) / (time.perf_counter() - t)
    rec["pos_acc"] = _token_acc(ppred, ptest)
    # the majority tag of each word in training, the baseline to beat
    counts = {}
    for toks, tg in ptrain:
        for w, g in zip(toks, tg):
            counts.setdefault(w, Counter())[g] += 1
    common = Counter(g for _, tg in ptrain for g in tg).most_common(1)[0][0]
    major = {w: c.most_common(1)[0][0] for w, c in counts.items()}
    rec["pos_majority_acc"] = _token_acc([[major.get(w, common) for w in s] for s, _ in ptest], ptest)
    log(f"13b CRF POS fit at {len(pos.tag_names)} tags on {n} sentences: {rec['pos_fit_s']:.3f} s, "
        f"{pst['epochs']} epochs, {pst['steps']} steps at {pst['steps_per_s']:.1f} steps/s; decode "
        f"{rec['pos_decode_per_s']:.1f} sentences/s; token accuracy {rec['pos_acc']:.4f} (each "
        f"word's majority tag {rec['pos_majority_acc']:.4f}) on {smi}")
    assert len(pos.tag_names) == P13_POS_TAGS
    assert rec["pos_acc"] > rec["pos_majority_acc"], rec
    return rec


def image_descriptors(dev, smi, size=P13_IMG, count=P13_IMAGES, mixed=P13_MIXED):
    """13c: HOG (bin 8) and DAISY (the defaults) on a batch of seeded
    images and on a mixed-size batch; two images card vs CPU under the
    golden bar."""
    from keystone_tpu_torch.ops.images.daisy import DaisyExtractor
    from keystone_tpu_torch.ops.images.hog import HogExtractor

    g = torch.Generator().manual_seed(133)
    imgs = torch.randint(0, 256, (count,) + size + (3,), generator=g, dtype=torch.uint8)
    # smooth them a little so that gradients are not all noise
    imgs = torch.nn.functional.avg_pool2d(imgs.permute(0, 3, 1, 2).float(), 3, 1, 1).permute(0, 2, 3, 1)
    mixed_imgs = [imgs[i, : s[0], : s[1]].clone() if s[0] <= size[0] and s[1] <= size[1]
                  else imgs[i].transpose(0, 1)[: s[0], : s[1]].clone() for i, s in enumerate(mixed)]
    rec = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for name, card, host, x in (
        ("hog", HogExtractor(8, device=dev), HogExtractor(8, device="cpu"), imgs),
        ("daisy", DaisyExtractor(device=dev), DaisyExtractor(device="cpu"), imgs[..., 0]),
    ):
        xd = x.to(dev)
        card.extract(xd[:2])  # warm
        times = []
        for _ in range(3):
            sync()
            t = time.perf_counter()
            out = card.extract(xd)
            sync()
            times.append(time.perf_counter() - t)
        assert bool(torch.isfinite(out).all())
        t = time.perf_counter()
        items = card.apply_batch(Dataset.from_items(mixed_imgs if name == "hog"
                                                    else [m[..., 0] for m in mixed_imgs])).items()
        sync()
        mixed_s = time.perf_counter() - t
        want = host.extract(x[:2])
        diff = (out[:2].cpu() - want).abs()
        within = float((diff <= 1e-3).float().mean())
        rec[name] = {"images_per_s": count / min(times), "batch_s": times,
                     "shape": list(out.shape), "mixed_images_per_s": len(mixed) / mixed_s,
                     "mixed_shapes": [list(o.shape) for o in items],
                     "within_1e-3": within, "max_abs_err": float(diff.max())}
        log(f"13c {name} on {count} images of {size[0]} x {size[1]}: "
            f"{rec[name]['images_per_s']:.1f} images/s (output {list(out.shape)}); mixed sizes "
            f"{rec[name]['mixed_images_per_s']:.1f} images/s; two images card vs CPU: "
            f"{within:.5f} within 1e-3, max {rec[name]['max_abs_err']:.3g}, on {smi}")
        assert within >= 0.995 and float(diff.max()) <= 0.05, rec[name]
        del xd, out
    return rec


def gram_and_qr(dev, smi, shape=P13_QR, check_rows=P13_CHECK_ROWS):
    """13d: ``gram`` and ``qr_q`` at 1,048,576 x 1,024 float32, and
    ``device_shuffle`` of a slice."""
    from keystone_tpu_torch.parallel.linalg import gram, qr_q
    from keystone_tpu_torch.parallel.shuffle import device_shuffle

    n, d = shape
    g = torch.Generator(device=dev).manual_seed(134)
    A = torch.randn((n, d), generator=g, device=dev)
    rec = {"n": n, "d": d, "bytes": A.numel() * 4}
    for name, fn in (("gram", lambda: gram(A)), ("qr_q", lambda: qr_q(A))):
        fn()  # the first call pays cuBLAS's and cuSOLVER's setup
        ms = []
        for _ in range(3):
            if dev.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            else:
                t = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t) * 1e3)
        rec[f"{name}_ms"] = ms
    G = gram(A)
    Q, R = qr_q(A)
    rec["ortho_err"] = float((gram(Q) - torch.eye(d, device=dev)).abs().max())
    rec["qr_rel_err"] = float(torch.linalg.norm(Q @ R - A) / torch.linalg.norm(A))
    del Q, R
    head = A[:check_rows]
    G64 = head.double().T @ head.double()
    rec["gram_rel_err"] = float((gram(head).double() - G64).abs().max() / G64.abs().max())
    rec["gram_full_finite"] = bool(torch.isfinite(G).all())
    # the one-device shuffle on the card: the host Shuffler's rows, pad rows zero
    padded = torch.cat([head, torch.zeros((1000, d), device=dev)])
    shuffled = device_shuffle(padded, check_rows, seed=13)
    perm = torch.as_tensor(np.random.default_rng(13).permutation(check_rows), device=dev)
    rec["shuffle_equal"] = bool(torch.equal(shuffled[:check_rows], head[perm])
                                and not shuffled[check_rows:].any())
    del padded, shuffled
    b16 = gram(head.to(torch.bfloat16))
    rec["bf16_dtype"] = str(b16.dtype)
    exact = head.to(torch.bfloat16).double()
    rec["bf16_rel_err"] = float((b16.double() - exact.T @ exact).abs().max()
                                / (exact.T @ exact).abs().max())
    flop = 2.0 * n * d * d
    rec["gram_tflops"] = flop / (min(rec["gram_ms"]) / 1e3) / 1e12
    log(f"13d gram at {n} x {d} float32: {min(rec['gram_ms']):.3f} ms ({rec['gram_tflops']:.1f} "
        f"TFLOP/s), qr_q {min(rec['qr_q_ms']):.3f} ms; max|QᵀQ − I| {rec['ortho_err']:.3g}, "
        f"‖QR − A‖/‖A‖ {rec['qr_rel_err']:.3g}; gram of {check_rows} rows against float64 "
        f"{rec['gram_rel_err']:.3g}, of bf16 rows {rec['bf16_rel_err']:.3g} ({rec['bf16_dtype']}); "
        f"device_shuffle of those rows equal to the host's: {rec['shuffle_equal']}, on {smi}")
    assert rec["gram_full_finite"] and rec["shuffle_equal"]
    assert rec["ortho_err"] <= MAX_ORTHO_ERR and rec["qr_rel_err"] <= RTOL_QR, rec
    assert rec["gram_rel_err"] <= RTOL_GRAM and rec["bf16_rel_err"] <= RTOL_GRAM, rec
    assert b16.dtype == torch.float32
    del A, G, head, G64, b16, exact
    return rec


def last_app_and_operators(dev, smi, sb=None, crf=None, images=None, qr=None):
    """Phase 13: 13a StupidBackoffPipeline (corpus under the gitignored
    ``tmp/phase13``), 13b the CRF taggers, 13c HOG and DAISY, 13d ``gram``
    and ``qr_q``. Each argument is a dict of keyword arguments of its
    sub-phase. To rehearse it on the CPU at a small size:
    ``last_app_and_operators(torch.device("cpu"), "cpu", sb=dict(lines=2000,
    vocab=5000, checks=200), crf=dict(conll=(600, 8700, 113),
    conll_test=150, parity_rows=64, n_epochs=20, pos_epochs=20),
    images=dict(size=(64, 48), count=4, mixed=((64, 48), (48, 64), (64, 40),
    (40, 64))), qr=dict(shape=(4096, 64), check_rows=1024))`` (about 15 s)."""
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "tmp", "phase13")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rec = {"card": smi}
    t = time.perf_counter()
    rec["stupid_backoff"] = stupid_backoff_app(dev, smi, root, **(sb or {}))
    rec["stupid_backoff"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["crf"] = crf_taggers(dev, smi, **(crf or {}))
    rec["crf"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["images"] = image_descriptors(dev, smi, **(images or {}))
    rec["images"]["phase_s"] = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rec["linalg"] = gram_and_qr(dev, smi, **(qr or {}))
    rec["linalg"]["phase_s"] = time.perf_counter() - t
    shutil.rmtree(root, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# -- phase 14: the gateway over the flagship's CUDA-graph engines -------------

# lanes, stage depth and batching deadline: serve-gateway's defaults (the
# buckets are the serving phases'); clients: requests in flight, seconds
# of the measured window and the image pool
P14_LANES, P14_DEPTH, P14_DELAY_MS = 2, 2, 5.0
P14_IN_FLIGHT, P14_SECONDS, P14_POOL = 64, 8.0, 64
# the device profile's window inside the measured one (start, length s):
# at the window's start the server decodes the first 64 bodies back to
# back; and /profilez's capture during the swap drill
P14_PROFILE_AT_S, P14_PROFILE_S, P14_PROFILEZ_S = 4.0, 2.0, 2
P14_ENTRY_EXIT_S = 30.0
# 14b's clients during the swap drill: 2 (its captures took 72–107 s under
# 64 JSON clients and 50 s under 8, whose handlers hold the GIL; 14a
# measures 64)
P14B_IN_FLIGHT = 2
# 14c: the fresh entry's clients (in flight, seconds, image pool); its
# first /profilez opens this long after they start
P14C_IN_FLIGHT, P14C_SECONDS, P14C_POOL, P14C_PROFILEZ_AT_S = 64, 4.0, 16, 1.0
# the most a profiler step may add to the entry's start (it takes none)
P14C_PROFILER_S = 0.5
# the JAX test's bar for Convolver(fast=True): its largest error against
# fast=False over the largest feature (tests/ops/test_precision_policy.py)
P14_FAST_CONV_BAR = 8e-3
P14_CONV_IMAGES, P14_FILTER_IMAGES = 1024, 2000
KERNEL_NAMES = ("sift_bin_sample", "plane_sandwich", "fisher_vector_stats")
PER_DISPATCH = {"sift_bin_sample": 4, "plane_sandwich": 1, "fisher_vector_stats": 2}


def gateway_clients(url, images_path, seconds, in_flight, out_path, path="/predict"):
    """Phase 14's (and 15's) client process: pre-encode one JSON body per
    image of ``images_path`` (``{"instances": [image]}``), print ``ready``,
    wait for ``go`` on stdin, then keep ``in_flight`` POSTs to ``path``
    (``/predict`` or ``/predict/<model>``) in flight (one thread each,
    closed loop) until ``seconds`` have passed or ``stop`` comes on
    stdin, and write every response (image index, status, top-5 or error
    reason, send and receive wall times) to ``out_path`` as JSON. It runs
    in a process of its own, so it shares no GIL with the server."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(url)
    images = np.load(images_path)
    t = time.perf_counter()
    bodies = [json.dumps({"instances": [im.tolist()]}).encode() for im in images]
    encode_s = time.perf_counter() - t
    print("ready", flush=True)
    sys.stdin.readline()
    results = []
    t0 = time.time()
    stop = threading.Event()
    threading.Thread(target=lambda: (sys.stdin.readline(), stop.set()), daemon=True).start()
    timer = threading.Timer(seconds, stop.set)
    timer.daemon = True
    timer.start()

    def client(tid):
        k = tid
        while not stop.is_set():
            i = k % len(bodies)
            k += in_flight
            t_send = time.time()
            try:
                conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
                conn.request("POST", path, body=bodies[i],
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                doc = json.loads(r.read())
                conn.close()
                what = doc["predictions"][0] if r.status == 200 else doc.get("reason", doc.get("error"))
                results.append((i, r.status, what, t_send, time.time()))
            except Exception as e:  # reported to the server process
                results.append((i, -1, repr(e), t_send, time.time()))

    threads = [threading.Thread(target=client, args=(tid,)) for tid in range(in_flight)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    with open(out_path, "w") as f:
        json.dump({"start": t0, "end": time.time(), "encode_s": encode_s,
                   "body_bytes": [len(b) for b in bodies], "results": results}, f)
    print("done", flush=True)


class ClientProcess:
    """``gateway_clients`` in a fresh ``python3``, started and gated: the
    constructor returns once the bodies are encoded, ``go()`` opens the
    window, ``result()`` waits for the end and reads the record."""

    def __init__(self, url, images_path, seconds, in_flight, out_path, path="/predict"):
        self.out_path = out_path
        self.seconds = seconds
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gateway-clients",
             json.dumps([url, images_path, seconds, in_flight, out_path, path])],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )
        line = self.proc.stdout.readline().strip()
        assert line == "ready", line

    def go(self):
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()
        self.t_go = time.time()

    def stop(self):
        self.proc.stdin.write("stop\n")
        self.proc.stdin.flush()

    def result(self):
        try:
            self.proc.wait(timeout=self.seconds + 180)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        assert self.proc.returncode == 0, self.proc.returncode
        with open(self.out_path) as f:
            return json.load(f)


GET_RESETS = []  # (url, error) of every reset GET that was read again


def http_get(url, timeout=30, accept_errors=False):
    """One GET: (status, body). A read of this script's own (a scrape, a
    status page) that the peer resets before its answer is logged and
    sent once more: a server that is gone still fails the second one,
    and what the phases check is the body. Clients' requests are
    counted by their own processes, and no POST is sent again."""
    import urllib.error
    import urllib.request

    for attempt in (0, 1):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            if not accept_errors:
                raise
            return e.code, e.read()
        except ConnectionResetError as e:
            if attempt:
                raise
            GET_RESETS.append((url, repr(e)))
            log(f"GET {url} reset before its answer ({e!r}); reading it once more")
            time.sleep(0.2)


def http_post(url, doc, timeout=120):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def top5_by_bucket(engine, images, buckets):
    """The chain's top-5 of every image when it rides a window of each
    bucket (eager, zero pad rows, as a replay computes it)."""
    out = {}
    for b in buckets:
        rows = []
        for s in range(0, len(images), b):
            chunk = images[s : s + b]
            pad = np.zeros((b,) + images.shape[1:], np.uint8)
            pad[: len(chunk)] = chunk
            rows.append(engine._run_bucket(torch.as_tensor(pad).to(engine.device))[: len(chunk)]
                        .cpu().numpy())
        out[b] = np.concatenate(rows)
    return out


def check_responses(results, want, t_drain=None):
    """Split the clients' responses: right (200 with the direct chain's
    top-5 at one of the buckets), refused after the drain began (503
    ``closed``), and failed (anything else)."""
    ok, refused, failed = [], [], []
    for i, status, what, t_send, t_recv in results:
        if status == 200 and any(list(w[i]) == what for w in want.values()):
            ok.append(t_recv - t_send)
        elif status == 503 and what == "closed" and t_drain is not None and t_recv >= t_drain:
            refused.append(t_recv - t_send)
        else:
            failed.append((i, status, what))
    return ok, refused, failed


def device_idle_share(trace_path, window_us):
    """1 − (the union of the card's kernel, copy and set intervals) ÷ the
    window, from a Kineto Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return 1.0 - busy / window_us, busy / 1e3, len(spans)


def profilez_kernels(url):
    """GET a ``/profilez`` URL and read its Chrome trace back: which of
    B1–B3 it names, how many kernel names and events of each category."""
    code, doc = http_get(url, accept_errors=True)
    doc = json.loads(doc)
    assert code == 200, doc
    names, cats = set(), Counter()
    for fname in doc["files"]:
        with open(os.path.join(doc["trace_dir"], fname)) as f:
            events = json.load(f)["traceEvents"]
        cats.update(e.get("cat") for e in events)
        names |= {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    seen = {k: any(s in n for n in names) for k, s in
            (("sift_bin_sample", "sift_bin"), ("plane_sandwich", "sandwich"),
             ("fisher_vector_stats", "fv_"))}
    return {"files": doc["files"], "kernels_seen": seen, "kernel_names": len(names),
            "events": dict(cats)}


def gateway_latency(text, name):
    """p50, p99 and mean ms of one gateway latency histogram, read back
    from a ``/metrics`` scrape as a scraper would."""
    from keystone_tpu_torch.observability import prometheus

    buckets = prometheus.histogram_buckets(text, name, {"gateway": "phase14"})
    samples = {s: v for s, labels, v in prometheus.parse_samples(text)
               if labels.get("gateway") == "phase14" and s in (f"{name}_sum", f"{name}_count")}
    q = {p: prometheus.quantile_from_buckets(p, buckets) for p in (0.5, 0.99)}
    mean = samples[f"{name}_sum"] / samples[f"{name}_count"] if samples.get(f"{name}_count") else None
    return {"p50_ms": q[0.5] and q[0.5] * 1e3, "p99_ms": q[0.99] and q[0.99] * 1e3,
            "mean_ms": mean and mean * 1e3, "count": samples.get(f"{name}_count")}


def lane_totals(gw):
    dispatches = sum(lane.engine.metrics.dispatches.total for lane in gw.pool.lanes)
    examples = sum(lane.engine.metrics.examples.total for lane in gw.pool.lanes)
    return dispatches, examples


def graph_pools(gw):
    graphs = [g for lane in gw.pool.lanes for g in lane.engine.graph_report()]
    return {"graphs": len(graphs), "pool_bytes": sum(g["pool_bytes"] for g in graphs),
            "capture_s": sum(g["capture_s"] for g in graphs),
            "buckets": sorted({g["bucket"] for g in graphs})}


def serve_gateway(dev, smi, feat, model, img=IMG, seconds=P14_SECONDS, in_flight=P14_IN_FLIGHT,
                  pool=P14_POOL, profile_at_s=P14_PROFILE_AT_S):
    """Phase 14a and 14b: phase 4's chain and head behind ``Gateway`` and
    ``GatewayServer`` (buckets (8, 64), 2 lanes, pipeline depth 2,
    max_delay_ms 5), loaded over HTTP by ``in_flight`` clients in another
    process; then the swap drill, ``/profilez``, the scrape and the drain
    under load: the drill's clients run until the drain has flipped
    ``/readyz``. To rehearse it on the CPU at a small size (no graphs, no
    profile): ``serve_gateway(torch.device("cpu"), "cpu", feat, model,
    img=48, seconds=2, in_flight=8, pool=8)`` with a 48² chain and its
    head."""
    from keystone_tpu_torch.gateway import Gateway, GatewayServer

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    root = os.path.join(ROOT, "tmp", "phase14")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(23)
    images = rng.integers(0, 256, (pool, img, img, 3), dtype=np.uint8)
    images_path = os.path.join(root, "images.npy")
    np.save(images_path, images)
    rec = {"card": smi, "lanes": P14_LANES, "pipeline_depth": P14_DEPTH,
           "max_delay_ms": P14_DELAY_MS, "buckets": list(BUCKETS), "in_flight": in_flight}

    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reserved0 = torch.cuda.memory_reserved(dev)
    t = time.perf_counter()
    gw = Gateway(model, buckets=BUCKETS, n_lanes=P14_LANES, pipeline_depth=P14_DEPTH,
                 max_delay_ms=P14_DELAY_MS, device_featurize=feat, device=dev,
                 warmup_example=np.zeros((img, img, 3), np.uint8), name="phase14")
    server = GatewayServer(gw, port=0, input_dtype=np.uint8).start()
    rec["build_s"] = time.perf_counter() - t
    rec["generation_1"] = graph_pools(gw)
    if on_card:
        rec["generation_1"]["reserved_bytes"] = torch.cuda.memory_reserved(dev) - reserved0
    log(f"14a: gateway up in {rec['build_s']:.3f} s, {P14_LANES} lanes, graphs "
        f"{rec['generation_1']} on {smi}")
    try:
        direct = model.compiled(buckets=BUCKETS, featurize=feat, device=dev, name="phase14-direct")
        want = top5_by_bucket(direct, images, BUCKETS)
        rec["direct_top5_differs_by_bucket"] = int((want[BUCKETS[0]] != want[BUCKETS[-1]]).any(1).sum())

        # the server's JSON decode of one body, alone (the handler's own
        # json.loads and np.asarray)
        bodies = [json.dumps({"instances": [im.tolist()]}).encode() for im in images[:16]]
        times = []
        for body in bodies:
            t = time.perf_counter()
            np.asarray(json.loads(body)["instances"][0], dtype=np.uint8)
            times.append(time.perf_counter() - t)
        rec["decode_ms_alone"] = statistics.median(times) * 1e3
        rec["body_bytes"] = len(bodies[0])

        # -- 14a: the measured window --------------------------------------
        clients = ClientProcess(server.url(), images_path, seconds, in_flight,
                                os.path.join(root, "load.json"))
        d0, e0 = lane_totals(gw)
        shed0 = sum(gw.metrics.shed_count(r) for r in ("queue_full", "deadline", "slo_pressure"))
        _cuda.reset_launches()
        clients.go()
        if on_card:
            time.sleep(profile_at_s)
            before = sum(_cuda.LAUNCHES.values())
            trace_dir = os.path.join(root, "idle")
            with profiling.trace(trace_dir):
                tp = time.perf_counter()
                time.sleep(P14_PROFILE_S)
                torch.cuda.synchronize(dev)
                window_us = (time.perf_counter() - tp) * 1e6
            (trace,) = os.listdir(trace_dir)
            idle, busy_ms, n_spans = device_idle_share(os.path.join(trace_dir, trace), window_us)
            rec["profile"] = {"idle_share": idle, "busy_ms": busy_ms, "window_ms": window_us / 1e3,
                              "device_spans": n_spans,
                              "kernel_launches_in_window": sum(_cuda.LAUNCHES.values()) - before}
            # a trace that saw none of the window's launches measured nothing
            assert n_spans > 0 or rec["profile"]["kernel_launches_in_window"] == 0, rec["profile"]
        load = clients.result()
        launches = dict(_cuda.LAUNCHES)
        d1, e1 = lane_totals(gw)
        ok, _, failed = check_responses(load["results"], want)
        assert not failed, failed[:5]
        elapsed = max(r[4] for r in load["results"]) - load["start"]
        lat = sorted(ok)
        _, text = http_get(server.url("/metrics"))
        text = text.decode()
        dispatches = d1 - d0
        rec["load"] = {
            "seconds": elapsed, "requests": len(ok), "req_per_s": len(ok) / elapsed,
            "p50_ms": lat[len(lat) // 2] * 1e3, "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
            "client_encode_s": load["encode_s"], "dispatches": dispatches,
            "mean_coalesced": (e1 - e0) / dispatches,
            "sheds": sum(gw.metrics.shed_count(r) for r in ("queue_full", "deadline", "slo_pressure")) - shed0,
            "admit_to_result": gateway_latency(text, "keystone_gateway_request_latency_seconds"),
            "queue_wait": gateway_latency(text, "keystone_gateway_queue_wait_seconds"),
            "launches": launches,
            "launches_per_dispatch": {k: launches[k] / dispatches for k in launches},
        }
        L = rec["load"]
        log(f"14a: {L['requests']} requests over HTTP in {elapsed:.3f} s: {L['req_per_s']:.1f} req/s, "
            f"client p50 {L['p50_ms']:.1f} ms, p99 {L['p99_ms']:.1f} ms ({in_flight} in flight); "
            f"admit -> result {L['admit_to_result']}; JSON decode of one {rec['body_bytes']}-byte body "
            f"alone {rec['decode_ms_alone']:.2f} ms; mean coalesced {L['mean_coalesced']:.2f} over "
            f"{dispatches} dispatches; sheds {L['sheds']}; launches {launches} "
            f"({L['launches_per_dispatch']} per dispatch); device {rec.get('profile')} on {smi}")
        want_launches = {k: PER_DISPATCH[k] * dispatches if on_card else 0 for k in KERNEL_NAMES}
        assert launches == want_launches, (launches, want_launches)
        if on_card:
            assert all(launches[k] > 0 for k in KERNEL_NAMES), launches

        # -- 14b: swap, profilez, scrape and drain under load ---------------
        clients = ClientProcess(server.url(), images_path, 600, min(in_flight, P14B_IN_FLIGHT),
                                os.path.join(root, "drill.json"))
        clients.go()
        time.sleep(min(2.0, seconds / 4))
        t = time.perf_counter()
        _, swapped = http_post(server.url("/swap"), {})
        rec["swap"] = {"wall_s": time.perf_counter() - t, "answer": swapped,
                       "generation_2": graph_pools(gw)}
        if on_card:
            rec["swap"]["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(dev)
            rec["swap"]["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        log(f"14b: POST /swap under load answered {swapped} in {rec['swap']['wall_s']:.3f} s; new "
            f"generation {rec['swap']['generation_2']}; peak reserved "
            f"{rec['swap'].get('peak_reserved_bytes')} bytes on {smi}")
        assert swapped["swapped"], swapped
        launched = sum(_cuda.LAUNCHES.values())
        rec["profilez"] = profilez_kernels(server.url(f"/profilez?seconds={P14_PROFILEZ_S}"))
        rec["profilez"]["launches_meanwhile"] = sum(_cuda.LAUNCHES.values()) - launched
        log(f"14b: /profilez?seconds={P14_PROFILEZ_S} during traffic: {rec['profilez']}")
        if on_card:
            assert all(rec["profilez"]["kernels_seen"].values()), rec["profilez"]
        _, text = http_get(server.url("/metrics"))
        text = text.decode()
        families = ("keystone_gateway_requests_total", "keystone_gateway_request_latency_seconds",
                    "keystone_gateway_engine_swaps_total", "keystone_gateway_shed_total",
                    "keystone_device_memory_bytes", "keystone_device_info")
        rec["families"] = {f: f"# TYPE {f} " in text for f in families}
        assert all(rec["families"].values()), rec["families"]
        rec["slz"], _ = http_get(server.url("/slz"))
        rec["debugz"], _ = http_get(server.url("/debugz"))
        assert rec["slz"] == 200 and rec["debugz"] == 200
        t_drain = time.time()
        code, _ = http_post(server.url("/drain"), {})
        ready = None
        for _ in range(100):
            ready, _ = http_get(server.url("/readyz"), accept_errors=True)
            if ready == 503:
                break
            time.sleep(0.1)
        time.sleep(0.5)  # new arrivals meet the closed gateway
        clients.stop()
        drill = clients.result()
        assert gw._drained.wait(60), "the drain did not finish"
        want.update(top5_by_bucket(direct, images, [b for b in gw.buckets if b not in want]))
        ok, refused, failed = check_responses(drill["results"], want, t_drain)
        rec["drill"] = {"responses": len(drill["results"]), "ok": len(ok), "refused_after_drain": len(refused),
                        "failed": len(failed), "readyz_after_drain": ready,
                        "buckets_after_swap": list(gw.buckets),
                        "queue_after_drain": gw.admission.queue_depth, "lane_load_after_drain": gw.pool.total_load()}
        log(f"14b: drill {rec['drill']}; swaps counted {gw.metrics.swap_count()}")
        assert not failed, failed[:5]
        assert ready == 503, ready
        assert rec["drill"]["queue_after_drain"] == 0 and rec["drill"]["lane_load_after_drain"] == 0
    finally:
        gw.close()
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def gateway_entry(img=IMG):
    """Phase 14c: ``python -m keystone_tpu_torch --admin-port 0
    serve-gateway --gateway-port 0 --device-featurize flagship --img 256
    --buckets 8,64 --lanes 2`` in a fresh process: read the listening
    line, POST one image; under clients' load, the process's first
    ``/profilez`` (on the admin endpoint) must name B1 and B2; scrape
    the admin endpoint, SIGTERM."""
    import signal

    root = os.path.join(ROOT, "tmp", "phase14c")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    images_path = os.path.join(root, "images.npy")
    np.save(images_path, np.random.default_rng(37).integers(
        0, 256, (P14C_POOL, img, img, 3), dtype=np.uint8))
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch", "--admin-port", "0", "serve-gateway",
         "--gateway-port", "0", "--device-featurize", "flagship", "--img", str(img),
         "--buckets", "8,64", "--lanes", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    rec, lines = {}, []
    try:
        admin = url = None
        while url is None:
            line = proc.stdout.readline()
            assert line, f"the entry exited early: {lines}"
            lines.append(line.rstrip())
            if line.startswith("admin endpoint: "):
                admin = line.split()[2]
            elif line.startswith("{"):
                listening = json.loads(line)
                url = listening["listening"]
        rec["up_s"] = time.perf_counter() - t
        # the start's split: a Gateway takes no profiler step before its
        # lanes (none is needed for /profilez to see them)
        rec["start_s"] = listening["start_s"]
        assert rec["start_s"].get("profiler", 0.0) < P14C_PROFILER_S, rec["start_s"]
        image = np.random.default_rng(29).integers(0, 256, (img, img, 3), dtype=np.uint8)
        t = time.perf_counter()
        code, doc = http_post(url + "/predict", {"instances": [image.tolist()]})
        rec["predict"] = {"status": code, "ms": (time.perf_counter() - t) * 1e3,
                          "outputs": len(doc["predictions"][0])}
        assert code == 200 and np.isfinite(doc["predictions"][0]).all(), code
        clients = ClientProcess(url, images_path, P14C_SECONDS, P14C_IN_FLIGHT,
                                os.path.join(root, "load.json"))
        clients.go()
        time.sleep(P14C_PROFILEZ_AT_S)
        t = time.perf_counter()
        rec["first_profilez"] = profilez_kernels(admin.rstrip("/") + f"/profilez?seconds={P14_PROFILEZ_S}")
        rec["first_profilez"]["s"] = time.perf_counter() - t
        load = clients.result()
        statuses = Counter(r[1] for r in load["results"])
        rec["load"] = {"in_flight": P14C_IN_FLIGHT, "statuses": dict(statuses)}
        log(f"14c: the fresh process's first /profilez?seconds={P14_PROFILEZ_S} under "
            f"{P14C_IN_FLIGHT} clients: {rec['first_profilez']}; responses {rec['load']}")
        assert set(statuses) == {200}, statuses
        # the entry's chain at its vocabulary of 16 runs the plain FV node
        # (the fused B3 node from 32 up, as in the JAX package): B1 and B2
        seen = rec["first_profilez"]["kernels_seen"]
        assert seen["sift_bin_sample"] and seen["plane_sandwich"], rec["first_profilez"]
        code_m, text = http_get(admin.rstrip("/") + "/metrics")
        code_h, health = http_get(admin.rstrip("/") + "/healthz")
        rec["admin"] = {"metrics": code_m, "healthz": code_h,
                        "gateway_families": "keystone_gateway_requests_total" in text.decode(),
                        "device_memory": "keystone_device_memory_bytes" in text.decode()}
        assert code_m == 200 and code_h == 200 and health == b"ok\n", rec["admin"]
        assert rec["admin"]["gateway_families"] and rec["admin"]["device_memory"], rec["admin"]
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=P14_ENTRY_EXIT_S)
        rec["exit"] = {"code": rc, "s": time.perf_counter() - t}
        assert rc == 0, (rc, lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    log(f"14c: the entry up in {rec['up_s']:.3f} s (imports, chain and graph captures; split "
        f"{rec['start_s']}), one POST {rec['predict']}, admin {rec['admin']}, SIGTERM -> exit "
        f"{rec['exit']}")
    return rec


def repairs_on_card(dev, smi, solver_xy, conv_images=P14_CONV_IMAGES, filter_images=P14_FILTER_IMAGES):
    """Phase 14d: the weighted solver on phase 6's features cast to bf16
    against the float32 fit of the same bf16 values, and
    ``Convolver(fast=True)`` against ``fast=False`` at RandomPatchCifar's
    shape (32² images, 100 whitened 6x6x3 filters from
    ``random_patch_cifar.build_filters``). To rehearse it on the CPU:
    ``repairs_on_card(torch.device("cpu"), "cpu", (X, Y), conv_images=64,
    filter_images=200)`` with a small float32 X and ±1 indicator Y."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    rec = {"card": smi}
    X, Y = solver_xy
    Xh = X.to(torch.bfloat16)
    lam, w = TRAIN_CONF["lam"], TRAIN_CONF["mixture_weight"]
    fits = {}
    data = {"bf16": Xh, "float32 of the bf16 values": Xh.to(torch.float32)}
    # in turns, so that neither side pays the first call's set-up alone
    for name in ("bf16", "float32 of the bf16 values", "float32 of the bf16 values", "bf16"):
        est = weighted_ls.BlockWeightedLeastSquaresEstimator(4096, 1, lam, w)
        sync()
        _reset_peak(dev)
        base = torch.cuda.memory_allocated(dev) if on_card else 0
        t = time.perf_counter()
        m = est.fit(Dataset.from_array(data[name]), Dataset.from_array(Y))
        sync()
        r = fits.setdefault(name, {"s": [], "features_bytes": data[name].numel() * data[name].element_size()})
        r["s"].append(time.perf_counter() - t)
        r.update(peak_above_start=(_peak(dev) - base) if on_card else None,
                 W=m.W.cpu(), intercept=m.intercept.cpu())
    errs = {p: float((fits["bf16"][p] - fits["float32 of the bf16 values"][p]).abs().max())
            for p in ("W", "intercept")}
    rec["solver"] = {k: {f: v for f, v in r.items() if f not in ("W", "intercept")}
                     for k, r in fits.items()}
    rec["solver"]["max_abs_err"] = errs
    rec["solver"]["shape"] = list(X.shape) + [Y.shape[1]]
    log(f"14d: weighted solver on {rec['solver']['shape']} bf16 features against the float32 fit of "
        f"the same values: max abs err {errs} (bar {ATOL_SOLVER}); {rec['solver']} on {smi}")
    assert max(errs.values()) <= ATOL_SOLVER, errs

    gen = np.random.default_rng(31)
    imgs = torch.as_tensor(gen.integers(0, 256, (max(conv_images, filter_images), 32, 32, 3))
                           .astype(np.float32), device=dev)
    filters, whitener = rpc.build_filters(Dataset.from_array(imgs[:filter_images]), rpc.RandomCifarConfig())
    x = imgs[:conv_images]
    out, ms = {}, {}
    for fast in (False, True):
        conv = core.Convolver(filters, 32, 32, 3, whitener=whitener, fast=fast)
        out[fast] = conv._convolve(x)
        sync()
        ms[fast] = time_ms(lambda: conv._convolve(x)) if on_card else None
    err = float((out[True] - out[False]).abs().max() / out[False].abs().max())
    # the filter convolution alone, float32 and with bf16 operands (what
    # the TPU's DEFAULT precision would run): fast stays float32 unless
    # bf16 wins here
    xc = x.permute(0, 3, 1, 2).contiguous()
    w = conv._weight(dev)
    operands = {"float32": (xc, w), "bf16": (xc.to(torch.bfloat16), w.to(torch.bfloat16))}
    filter_ms = {k: time_ms(lambda a=a, b=b: torch.nn.functional.conv2d(a, b)) if on_card else None
                 for k, (a, b) in operands.items()}
    rec["convolver_fast"] = {"images": conv_images, "filters": list(filters.shape), "err_over_max": err,
                             "bar": P14_FAST_CONV_BAR, "ms_fast": ms[True], "ms_float32": ms[False],
                             "filter_conv_ms": filter_ms}
    log(f"14d: Convolver fast=True against fast=False on {conv_images} 32x32x3 images, filters "
        f"{list(filters.shape)}: largest error over the largest feature {err:.3e} (bar "
        f"{P14_FAST_CONV_BAR}); {ms[True]} ms against {ms[False]} ms; the filter convolution "
        f"alone {filter_ms} ms on {smi}")
    assert err <= P14_FAST_CONV_BAR, err
    return rec


def gateway_phase(dev, smi, feat, model, solver_xy):
    """Phase 14: 14a and 14b (``serve_gateway``), 14c
    (``gateway_entry``) and 14d (``repairs_on_card``)."""
    t = time.perf_counter()
    rec = {"served": serve_gateway(dev, smi, feat, model)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["entry"] = gateway_entry()
    rec["repairs"] = repairs_on_card(dev, smi, solver_xy)
    rec["phase_s"] = time.perf_counter() - t
    log(f"phase 14 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# -- phase 15: the fleet tier and the model zoo -------------------------------

# clients as phase 14's (requests in flight, seconds of a window, image
# pool); a server process's start-up bound (imports, CUDA context, graph
# captures) and exit bound
P15_IN_FLIGHT, P15_SECONDS, P15_POOL = 64, 5.0, 64
P15_UP_S, P15_EXIT_S = 240.0, 60.0
# the kill drill: the kill this long into the clients' window, then the
# bounds on the router seeing it, on the restarted replica serving again,
# and the clients' run after that
P15_KILL_AT_S, P15_DETECT_S, P15_RECOVER_S, P15_AFTER_S = 3.0, 30.0, 60.0, 2.0
# the zoo: two flagship models of one featurize chain (serve-gateway's
# flagship widths, heads of different seeds) and the demo model; the
# shifted size mix of 15b's drift check (the plan's baseline is single
# rows)
P15_DEMO_D = 256
P15_DRIFT_SIZE = 8


def p15_spec(img=IMG, pinned=True):
    """The zoo's spec: two flagship models of one featurize chain (its
    serving widths, heads of different seeds) and the demo model."""
    return {"models": [
        {"name": "flagship-a", "device_featurize": "flagship", "img": img, "hidden": 512,
         "depth": 4, "seed": 1, "buckets": list(BUCKETS), "lanes": 2, "default": True,
         "pinned": pinned, "expected_sizes": {"1": 100}},
        {"name": "flagship-b", "device_featurize": "flagship", "img": img, "hidden": 512,
         "depth": 4, "seed": 2, "buckets": list(BUCKETS), "lanes": 2, "pinned": pinned,
         "expected_sizes": {"1": 100}},
        {"name": "demo", "d": P15_DEMO_D, "hidden": 512, "depth": 4, "seed": 3, "buckets": [8, 32],
         "lanes": 1, "expected_sizes": {"1": 100}},
    ]}
P15_TIMES = 5  # 15c: median of this many timed bucket-64 dispatches


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerProcess:
    """``python -m keystone_tpu_torch <argv>`` in a fresh process (on the
    CPU, the same entry given ``device="cpu"``), its stdout drained on a
    thread (JSON lines queued), its stderr appended to ``log_path``."""

    def __init__(self, argv, log_path, dev, env=None):
        import queue

        self.argv = argv
        self._log = open(log_path, "a")
        entry = ["-m", "keystone_tpu_torch"] if dev.type == "cuda" else [
            "-c", "import sys; from keystone_tpu_torch.__main__ import main; "
                  "sys.exit(main(sys.argv[1:], device='cpu'))"]
        self.started = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable] + entry + argv, cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=self._log, text=True,
                                     env=None if env is None else {**os.environ, **env})
        self.lines = []
        # (seconds since the start, doc) of every JSON line, as it arrived
        self.arrivals = []
        self._docs = queue.Queue()
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            if line.startswith("{"):
                with contextlib.suppress(ValueError):
                    doc = json.loads(line)
                    self.arrivals.append((time.perf_counter() - self.started, doc))
                    self._docs.put(doc)
        self._docs.put(None)

    def wait_json(self, key, timeout=P15_UP_S):
        """The first JSON stdout line holding ``key``."""
        import queue

        deadline = time.time() + timeout
        while True:
            try:
                doc = self._docs.get(timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                raise AssertionError(f"{self.argv}: no {key!r} line in {timeout} s: "
                                     f"{self.lines[-5:]}") from None
            if doc is None:
                raise AssertionError(f"{self.argv} exited ({self.proc.poll()}): {self.lines[-10:]}")
            if key in doc:
                return doc

    def stop(self, timeout=P15_EXIT_S):
        """SIGTERM, then the exit code and the seconds to it."""
        import signal

        t = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=timeout)
        return rc, time.perf_counter() - t

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()


class OtlpCollector:
    """A stdlib OTLP/HTTP collector on an ephemeral port: the resource
    attributes and span names of every batch POSTed to ``/v1/traces``.
    A body that does not parse (an exporter killed mid-POST) is counted
    in ``bad_bodies``."""

    def __init__(self):
        import http.server

        batches = self.batches = []
        bad = self.bad_bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                try:
                    doc = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                except ValueError:
                    bad.append(self.path)
                    self.send_error(400)
                    return
                for rs in doc.get("resourceSpans", []):
                    attrs = {a["key"]: next(iter(a["value"].values()))
                             for a in rs["resource"]["attributes"]}
                    names = [s["name"] for ss in rs["scopeSpans"] for s in ss["spans"]]
                    batches.append((self.path, attrs, names))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def by_process(self):
        """(service.name, replica) -> spans received and their names."""
        out = {}
        for path, attrs, names in list(self.batches):
            assert path == "/v1/traces", path
            row = out.setdefault((attrs.get("service.name"), attrs.get("replica")),
                                 {"spans": 0, "names": set()})
            row["spans"] += len(names)
            row["names"].update(names)
        return out

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def fleetz(url):
    return json.loads(http_get(url + "/fleetz")[1])


def metric_sum(url, name, **labels):
    """The samples of ``name`` on a ``/metrics`` scrape that carry
    ``labels``, summed over their other labels."""
    from keystone_tpu_torch.observability import prometheus

    text = http_get(url + "/metrics")[1].decode()
    return sum(v for n, lab, v in prometheus.parse_samples(text)
               if n == name and all(lab.get(k) == want for k, want in labels.items()))


def requests_ok(url):
    """``keystone_gateway_requests_total{status="ok"}`` summed over a
    ``/metrics`` scrape."""
    return metric_sum(url, "keystone_gateway_requests_total", status="ok")


def post_traced(url, doc, trace_id, timeout=120):
    """POST with a W3C ``traceparent``; returns (status, body, the
    ``X-Keystone-Trace`` header)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(doc).encode(), headers={
        "Content-Type": "application/json", "traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), r.headers.get("X-Keystone-Trace")


def window_stats(res, want, what):
    """req/s and client p50/p99 ms of one clients' window, every response
    held against the eager chain's output of its image (at either
    bucket): returns the record, raises on any failed or wrong one."""
    lat, failed = [], []
    for i, status, what_got, t_send, t_recv in res["results"]:
        if status != 200:
            failed.append((i, status, what_got))
            continue
        got = np.asarray(what_got, np.float32)
        if not any(np.allclose(got, w[i], rtol=RTOL_FEAT, atol=ATOL_FEAT) for w in want.values()):
            failed.append((i, "wrong", float(np.abs(got - want[8][i]).max())))
            continue
        lat.append(t_recv - t_send)
    assert not failed and lat, f"{what}: {len(failed)} failed of {len(res['results'])}: {failed[:5]}"
    span = res["end"] - res["start"]
    return {"requests": len(lat), "req_s": len(lat) / span, "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3, "seconds": span}


def fleet_drill(dev, smi, root, images_path, collector, img=IMG, seconds=P15_SECONDS,
                in_flight=P15_IN_FLIGHT):
    """Phase 15a: ``serve-router`` and two flagship ``serve-gateway
    --trace --register`` replicas, each a process of its own on the card,
    every one exporting spans to ``collector``. Returns the record, the
    router's URL and its process (15b registers with it)."""
    log_path = os.path.join(root, "servers.log")
    rec, procs = {}, []
    images = np.load(images_path)
    try:
        ports = {n: free_port() for n in ("router", "a", "b")}
        urls = {n: f"http://127.0.0.1:{p}" for n, p in ports.items()}
        rurl = urls.pop("router")
        t = time.perf_counter()
        # the router is host-only: it starts beside the first replica,
        # which retries its registration until the router listens
        router = ServerProcess(["--otlp-endpoint", collector.url, "--otlp-service", "keystone-router",
                                "--otlp-replica", "router", "serve-router", "--router-port",
                                str(ports["router"]), "--probe-interval", "0.5",
                                "--recovery-after", "2"], log_path, dev)
        procs.append(router)

        def start_replica(n):
            return ServerProcess(
                ["--otlp-endpoint", collector.url, "--otlp-service", "keystone-gateway",
                 "--otlp-replica", f"replica-{n}", "serve-gateway", "--gateway-port", str(ports[n]),
                 "--device-featurize", "flagship", "--img", str(img), "--buckets", "8,64",
                 "--lanes", "2", "--trace", "--register", rurl], log_path, dev)

        # both replicas start together (one after another, each took
        # 20.7–21.1 s on an H100)
        replicas = {}
        for n in ("a", "b"):
            replicas[n] = start_replica(n)
            procs.append(replicas[n])
        assert router.wait_json("listening")["listening"] == rurl
        rec["router_up_s"] = time.perf_counter() - t
        for n in ("a", "b"):
            assert replicas[n].wait_json("listening")["listening"] == urls[n]
            rec[f"replica_{n}_up_s"] = time.perf_counter() - t
        deadline = time.time() + 60
        while time.time() < deadline and sum(r["healthy"] and r["ready"]
                                             for r in fleetz(rurl)["replicas"]) < 2:
            time.sleep(0.2)
        roster = fleetz(rurl)
        assert [r["state"] for r in roster["replicas"]] == ["healthy"] * 2, roster
        log(f"15a: router up in {rec['router_up_s']:.3f} s, replicas in {rec['replica_a_up_s']:.3f} "
            f"and {rec['replica_b_up_s']:.3f} s (started together)")

        # -- right answers: the eager chain in this process at both buckets
        from keystone_tpu_torch.serving.bench import build_pipeline

        feat, d = build_flagship_featurize_pipeline(img=img, device=dev)
        head = build_pipeline(d=d, hidden=512, depth=4, device=dev)  # serve-gateway's defaults
        want = {}
        for b in BUCKETS:
            rows = []
            for s in range(0, len(images), b):
                pad = np.zeros((b,) + images.shape[1:], np.uint8)
                chunk = images[s : s + b]
                pad[: len(chunk)] = chunk
                with torch.no_grad():
                    out = head._batch_run(feat._batch_run(torch.as_tensor(pad, device=dev)))
                rows.append(out[: len(chunk)].cpu().numpy())
            want[b] = np.concatenate(rows)
        del feat, head
        trace_id = os.urandom(16).hex()
        code, doc, echoed = post_traced(rurl + "/predict", {"instances": [images[0].tolist()]}, trace_id)
        assert code == 200 and echoed == trace_id, (code, echoed)
        rec["max_abs_err"] = {"router": max_abs_err(np.asarray(doc["predictions"][0], np.float32),
                                                    want[8][0], RTOL_FEAT, ATOL_FEAT,
                                                    "15a: the router's answer against the eager chain")}
        code, doc = http_post(urls["a"] + "/predict", {"instances": [images[0].tolist()]})
        rec["max_abs_err"]["replica"] = max_abs_err(np.asarray(doc["predictions"][0], np.float32),
                                                    want[8][0], RTOL_FEAT, ATOL_FEAT,
                                                    "15a: a replica's answer against the eager chain")
        # -- the stitched trace of that routed request, from both tiers
        stitched = json.loads(http_get(rurl + f"/debugz?trace_id={trace_id}")[1])
        phases = stitched["phases_ms"]
        rec["stitched"] = {"processes": stitched["processes"], "partial": stitched["partial"],
                           "total_ms": stitched["total_ms"], "phases_ms": phases,
                           "spans": len(stitched["spans"])}
        log(f"15a: stitched /debugz of a routed request: {rec['stitched']}")
        assert stitched["partial"] is False, stitched["partial_detail"]
        assert stitched["processes"][0] == "router" and len(stitched["processes"]) == 2
        assert stitched["processes"][1].startswith("replica:127.0.0.1:"), stitched["processes"]
        assert abs(sum(phases.values()) - stitched["total_ms"]) <= 1.0, stitched
        assert phases["device"] > 0, phases

        # -- 64 clients through the router, then straight at one replica
        before = {n: requests_ok(u) for n, u in urls.items()}
        clients = ClientProcess(rurl, images_path, seconds, in_flight,
                                os.path.join(root, "routed.json"))
        clients.go()
        rec["routed"] = window_stats(clients.result(), want, "15a through the router")
        served = {n: requests_ok(u) - before[n] for n, u in urls.items()}
        assert sum(served.values()) == rec["routed"]["requests"], (served, rec["routed"])
        rec["routed"]["replica_share"] = {n: v / sum(served.values()) for n, v in served.items()}
        clients = ClientProcess(urls["a"], images_path, seconds, in_flight,
                                os.path.join(root, "direct.json"))
        clients.go()
        rec["direct"] = window_stats(clients.result(), want, "15a straight at a replica")
        log(f"15a: {in_flight} clients for {seconds} s through the router {rec['routed']}; "
            f"straight at one replica {rec['direct']} on {smi}")
        # -- the federated scrape against the replicas' own
        fed, own = requests_ok(rurl), sum(requests_ok(u) for u in urls.values())
        rec["federated_requests_ok"] = {"router": fed, "replicas": own}
        assert fed == own, rec["federated_requests_ok"]

        # -- kill -9 one replica under load, restart it on its port
        drill = ClientProcess(rurl, images_path, 600, in_flight, os.path.join(root, "drill.json"))
        drill.go()
        time.sleep(P15_KILL_AT_S)
        name_b = urls["b"].split("//")[1]

        def state_b():
            row = next((r for r in fleetz(rurl)["replicas"] if r["name"] == name_b), None)
            return row and (row["state"], row["ready"])

        replicas["b"].kill()
        t_kill = time.perf_counter()
        seen = []
        while time.perf_counter() - t_kill < P15_DETECT_S:
            st = state_b()
            if not seen or seen[-1][1] != st:
                seen.append((round(time.perf_counter() - t_kill, 3), st))
            if st and st[0] in ("unhealthy", "unreachable"):
                break
            time.sleep(0.1)
        assert seen and seen[-1][1] and seen[-1][1][0] in ("unhealthy", "unreachable"), seen
        rec["kill"] = {"detected_s": seen[-1][0]}
        t = time.perf_counter()
        replicas["b"] = start_replica("b")
        procs.append(replicas["b"])
        replicas["b"].wait_json("listening")
        rec["kill"]["restart_up_s"] = time.perf_counter() - t
        while time.perf_counter() - t_kill < P15_DETECT_S + P15_RECOVER_S + rec["kill"]["restart_up_s"]:
            st = state_b()
            if seen[-1][1] != st:
                seen.append((round(time.perf_counter() - t_kill, 3), st))
            if st == ("healthy", True) and requests_ok(urls["b"]) > 0:
                break
            time.sleep(0.1)
        rec["kill"]["states_after_kill_s"] = seen
        assert seen[-1][1] == ("healthy", True), seen
        rec["kill"]["recovered_s"] = seen[-1][0]
        time.sleep(P15_AFTER_S)
        drill.stop()
        res = drill.result()
        rec["kill"]["clients"] = window_stats(res, want, "15a across the kill -9")
        rec["kill"]["restarted_served"] = requests_ok(urls["b"])
        log(f"15a: kill -9 of replica b under {in_flight} clients: {rec['kill']}")

        # -- graceful exits: each replica deregisters, drains, exits 0
        for n in ("a", "b"):
            rc, s = replicas[n].stop()
            rec[f"replica_{n}_exit"] = {"code": rc, "s": s}
            assert rc == 0, (n, rc, replicas[n].lines[-5:])
        assert fleetz(rurl)["replicas"] == [], fleetz(rurl)
        return rec, rurl, router
    except BaseException:
        for p in procs:
            p.kill()
        raise


def zoo_entry(dev, smi, root, rurl, collector, img=IMG):
    """Phase 15b over HTTP: ``serve-gateway --zoo`` with the three-model
    spec, ``--optimize --max-resident 2``, registered with 15a's router:
    ``/planz`` shows the flagship pair in one shared unit, each model
    answers ``/predict/<model>`` through the router (the demo model pages
    in on its first request), ``/attributionz`` shares sum to 1 on the
    zoo and through the router, ``/driftz`` flags the demo model after a
    shifted size mix; SIGTERM, exit 0, the roster empty."""
    spec_path = os.path.join(root, "zoo.json")
    with open(spec_path, "w") as f:
        json.dump(p15_spec(img), f)
    log_path = os.path.join(root, "servers.log")
    rec = {}
    t = time.perf_counter()
    zoo = ServerProcess(["--otlp-endpoint", collector.url, "--otlp-service", "keystone-gateway",
                         "--otlp-replica", "zoo", "serve-gateway", "--gateway-port", "0",
                         "--zoo", spec_path, "--optimize", "--max-resident", "2", "--trace",
                         "--register", rurl], log_path, dev)
    try:
        rec["plan"] = zoo.wait_json("plan")["plan"]
        line = zoo.wait_json("listening")
        zurl = line["listening"]
        rec["up_s"] = time.perf_counter() - t
        assert line["models"] == ["flagship-a", "flagship-b", "demo"], line
        deadline = time.time() + 30
        while time.time() < deadline and not fleetz(rurl)["replicas"]:
            time.sleep(0.2)
        assert fleetz(rurl)["replicas"][0]["models"] == ["demo", "flagship-a", "flagship-b"]
        planz = json.loads(http_get(zurl + "/planz")[1])
        actual = planz["actual"]
        assert actual["flagship-a"]["shared_with"] == ["flagship-b"], actual
        assert actual["flagship-b"]["shared_with"] == ["flagship-a"], actual
        assert actual["demo"]["resident"] is False, actual
        image = np.random.default_rng(43).integers(0, 256, (img, img, 3), dtype=np.uint8)
        x = np.random.default_rng(44).standard_normal(P15_DEMO_D).astype(np.float32)
        rec["predict_ms"] = {}
        outs = {}
        for model, inst in (("flagship-a", image.tolist()), ("flagship-b", image.tolist()),
                            ("demo", x.tolist())):
            t = time.perf_counter()
            code, doc = http_post(rurl + f"/predict/{model}", {"instances": [inst]})
            rec["predict_ms"][model] = (time.perf_counter() - t) * 1e3
            outs[model] = np.asarray(doc["predictions"][0])
            assert code == 200 and np.isfinite(outs[model]).all(), (model, code)
        assert not np.allclose(outs["flagship-a"], outs["flagship-b"])
        actual = json.loads(http_get(zurl + "/planz")[1])["actual"]
        rec["resident_after"] = {m: row["resident"] for m, row in actual.items()}
        # both flagship models are pinned (the shared unit is hosted at
        # start-up), so the demo model pages in over the cap of 2
        assert rec["resident_after"] == {"flagship-a": True, "flagship-b": True, "demo": True}
        for src, url in (("zoo", zurl), ("router", rurl)):
            doc = json.loads(http_get(url + "/attributionz")[1])
            shares = [e["device_seconds_share"] for e in doc["models"].values()]
            rec[f"attribution_{src}"] = {m: e["device_seconds_share"] for m, e in doc["models"].items()}
            assert sorted(doc["models"]) == ["demo", "flagship-a", "flagship-b"], doc["models"]
            assert abs(sum(shares) - 1.0) <= 1e-9, shares
        for _ in range(32):  # the drift detector's min_rows
            code, _ = http_post(zurl + "/predict/demo", {"instances": [x.tolist()] * P15_DRIFT_SIZE})
            assert code == 200
        drift = json.loads(http_get(zurl + "/driftz")[1])
        rec["drift"] = {"scores": drift["scores"], "drifted": drift["drifted"],
                        "router": json.loads(http_get(rurl + "/driftz")[1])["drifted"]}
        assert drift["drifted"] == ["demo"] and rec["drift"]["router"] == ["demo"], rec["drift"]
        assert drift["recommendation"] and "changes" in drift["recommendation"], drift
        rc, s = zoo.stop()
        rec["exit"] = {"code": rc, "s": s}
        assert rc == 0, zoo.lines[-5:]
        assert fleetz(rurl)["replicas"] == []
        log(f"15b: the zoo up in {rec['up_s']:.3f} s; /predict/<model> through the router "
            f"{rec['predict_ms']} ms; resident {rec['resident_after']}; attribution "
            f"{rec['attribution_router']}; drift {rec['drift']}; exit {rec['exit']}")
        return rec
    finally:
        zoo.kill()


def zoo_in_process(dev, smi, root, img=IMG):
    """Phase 15b's engine half and 15c, in this process: the spec's
    flagship pair hosted together is ONE shared unit (one graph per
    bucket per lane), whose replay launches B1 and B2 as often as a solo
    flagship replay; each head within RTOL_FEAT/ATOL_FEAT of its solo
    engine; ex/s at bucket 64 of the shared unit against the two solo
    engines; the featurize token alike on the card and the CPU; then the
    LRU cycle at ``max_resident=2`` with every model unpinned: the demo
    model's page-in evicts the shared unit, which drains on a background
    thread while the demo model serves, and releases its graphs
    (page-in and eviction seconds; ``memory_reserved`` and
    ``memory_allocated`` before, after the page-in and after the
    eviction, then after ``empty_cache``)."""
    from keystone_tpu_torch.serving.featurize import featurize_token
    from keystone_tpu_torch.zoo import ModelZoo, load_zoo_spec

    spec_path = os.path.join(root, "zoo-unpinned.json")
    with open(spec_path, "w") as f:
        json.dump(p15_spec(img, pinned=False), f)
    on_card = dev.type == "cuda"

    def memory():
        if not on_card:
            return None, None
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev)

    rec = {}
    zoo = ModelZoo(load_zoo_spec(spec_path, device=dev), max_resident=2, device=dev)
    solo = {}
    try:
        t = time.perf_counter()
        assert zoo.host(["flagship-a", "flagship-b"]) == [("flagship-a", "flagship-b")]
        rec["shared_page_in_s"] = time.perf_counter() - t
        unit = zoo._by_model["flagship-a"]
        assert unit.shared and unit is zoo._by_model["flagship-b"]
        graphs = [g for lane in unit.gateway.pool.lanes for g in lane.engine.graph_report()]
        rec["shared_graphs"] = [{k: g[k] for k in ("bucket", "capture_s", "pool_bytes", "launches")}
                                for g in graphs]
        for lane in unit.gateway.pool.lanes:  # one graph per bucket for the whole group
            assert sorted(g["bucket"] for g in lane.engine.graph_report()) == (
                list(BUCKETS) if on_card else [])
        shared = unit.gateway.pool.lanes[0].engine
        builts = {m: zoo._built(m) for m in ("flagship-a", "flagship-b")}
        example = torch.zeros((img, img, 3), dtype=torch.uint8)
        for m, b in builts.items():
            solo[m] = b.fitted.compiled(BUCKETS, featurize=b.featurize, device=dev,
                                        name=f"phase15-solo-{m}")
            solo[m].warmup(example=example)
        per_replay = {"shared": {g["bucket"]: g["launches"] for g in shared.graph_report()},
                      "solo": {g["bucket"]: g["launches"] for g in solo["flagship-a"].graph_report()}}
        for b in BUCKETS if on_card else ():
            for k in ("sift_bin_sample", "plane_sandwich"):
                assert per_replay["shared"][b][k] == per_replay["solo"][b][k] > 0, per_replay
        rec["launches_per_replay"] = per_replay
        images = np.random.default_rng(45).integers(0, 256, (B, img, img, 3), dtype=np.uint8)

        def counted(fn):
            before = dict(_cuda.LAUNCHES)
            out = fn()
            return out, {k: _cuda.LAUNCHES[k] - before[k] for k in before}

        out, rec["live_launches_shared"] = counted(lambda: shared.apply(images, sync=True))
        want, rec["live_launches_solo"] = counted(lambda: solo["flagship-a"].apply(images, sync=True))
        for k in ("sift_bin_sample", "plane_sandwich"):  # the CPU runs the plain versions
            assert rec["live_launches_shared"][k] == rec["live_launches_solo"][k] > (-1 if not on_card
                                                                                   else 0), rec
        rec["head_max_abs_err"] = {
            m: max_abs_err(out[m], solo[m].apply(images, sync=True), RTOL_FEAT, ATOL_FEAT,
                           f"15b: head {m} of the shared unit against its solo engine")
            for m in solo}
        # -- 15c: both flagship models on the same 64 images, bucket 64
        def timed(fn):
            fn()
            ts = []
            for _ in range(P15_TIMES):
                t = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t)
            return statistics.median(ts)

        t_shared = timed(lambda: shared.apply(images, sync=True))
        t_solo = timed(lambda: [solo[m].apply(images, sync=True) for m in solo])
        rec["cse"] = {"bucket": B, "shared_ms": t_shared * 1e3, "solo_pair_ms": t_solo * 1e3,
                      "shared_ex_s": B / t_shared, "solo_ex_s": B / t_solo, "speedup": t_solo / t_shared}
        log(f"15c: both flagship models on {B} images: one shared unit {rec['cse']['shared_ms']:.3f} ms "
            f"({rec['cse']['shared_ex_s']:.1f} ex/s), two solo units {rec['cse']['solo_pair_ms']:.3f} ms "
            f"({rec['cse']['solo_ex_s']:.1f} ex/s), x{rec['cse']['speedup']:.3f} on {smi}")
        cpu_feat, _ = build_flagship_featurize_pipeline(img=img, device="cpu")
        rec["token_card_equals_cpu"] = featurize_token(builts["flagship-a"].featurize) == \
            featurize_token(cpu_feat)
        assert rec["token_card_equals_cpu"]
        for e in solo.values():
            e.release_graphs()
        solo.clear()

        # -- the LRU cycle: the demo model's page-in evicts the shared unit,
        # -- which drains its windows in flight while the demo model serves
        if on_card:
            torch.cuda.empty_cache()  # the solo engines' pools, released above
        rec["shared_pool_bytes"] = sum(g["pool_bytes"] for g in rec["shared_graphs"])
        mem = {"before": memory()}
        in_flight = [zoo.predict(images[i], "flagship-a") for i in range(len(images))]
        x = np.zeros(P15_DEMO_D, np.float32)
        t = time.perf_counter()
        zoo.predict(x, "demo").result(timeout=120)
        rec["demo_page_in_s"] = time.perf_counter() - t
        assert "flagship-a" not in zoo._by_model and "demo" in zoo._by_model
        demo_unit = zoo._by_model["demo"]
        served = 0
        while unit.retired is None:  # the other unit keeps replaying
            zoo.predict(x, "demo").result(timeout=60)
            served += 1
            assert time.perf_counter() - t < 120, "the evicted unit did not retire"
        rec["eviction"] = dict(unit.retired)
        rec["demo_served_during_eviction"] = served
        rec["in_flight_max_abs_err"] = max(  # the evicted unit's windows all resolved
            max_abs_err(np.asarray(f.result(timeout=60)), out["flagship-a"][i].cpu(), RTOL_FEAT,
                        ATOL_FEAT, "15b: a request in flight across the eviction")
            for i, f in enumerate(in_flight))
        mem["after_page_in_and_eviction"] = memory()
        rec["demo_pool_bytes"] = sum(g["pool_bytes"] for lane in demo_unit.gateway.pool.lanes
                                     for g in lane.engine.graph_report())
        if on_card:
            torch.cuda.empty_cache()
            mem["after_empty_cache"] = memory()
            freed = mem["after_page_in_and_eviction"][0] - mem["after_empty_cache"][0]
            # the evicted unit's pools stay cached until empty_cache returns them
            assert freed >= 0.5 * rec["shared_pool_bytes"] > 0, (freed, rec["shared_pool_bytes"], mem)
        rec["memory"] = {k: {"reserved": r, "allocated": a} for k, (r, a) in mem.items()}
        log(f"15b: shared unit paged in in {rec['shared_page_in_s']:.3f} s (graph pools "
            f"{rec['shared_pool_bytes']} B); the demo model's page-in {rec['demo_page_in_s']:.3f} s "
            f"evicted it with {len(in_flight)} requests in flight: {rec['eviction']}, {served} demo "
            f"requests meanwhile; memory {rec['memory']} on {smi}")
        return rec
    finally:
        for e in solo.values():
            e.release_graphs()
        zoo.close()


def fleet_and_zoo(dev, smi, img=IMG, seconds=P15_SECONDS, in_flight=P15_IN_FLIGHT, pool=P15_POOL):
    """Phase 15: 15a (``fleet_drill``), 15b (``zoo_entry`` over HTTP and
    ``zoo_in_process``) and 15c (in ``zoo_in_process``), and the spans
    the OTLP collector received from every server process. To rehearse
    it on the CPU at a small size: ``fleet_and_zoo(torch.device("cpu"),
    "cpu", img=48, seconds=2, in_flight=8, pool=8)``."""
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "tmp", "phase15")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    images_path = os.path.join(root, "images.npy")
    np.save(images_path, np.random.default_rng(41).integers(0, 256, (pool, img, img, 3),
                                                             dtype=np.uint8))
    collector = OtlpCollector()
    router = None
    rec = {"card": smi}
    try:
        rec["fleet"], rurl, router = fleet_drill(dev, smi, root, images_path, collector, img=img,
                                                 seconds=seconds, in_flight=in_flight)
        rec["zoo"] = zoo_entry(dev, smi, root, rurl, collector, img=img)
        rc, s = router.stop()
        rec["router_exit"] = {"code": rc, "s": s}
        assert rc == 0, router.lines[-5:]
        got = collector.by_process()
        rec["otlp"] = {f"{svc}/{rep}": {"spans": row["spans"], "names": sorted(row["names"])}
                       for (svc, rep), row in got.items()}
        rec["otlp_bad_bodies"] = len(collector.bad_bodies)
        log(f"15a: OTLP spans received by process: {rec['otlp']}")
        for key, name in ((("keystone-router", "router"), "router.forward"),
                          (("keystone-gateway", "replica-a"), "gateway.admit"),
                          (("keystone-gateway", "replica-b"), "gateway.admit")):
            assert key in got and name in got[key]["names"], (key, rec["otlp"])
        rec["engines"] = zoo_in_process(dev, smi, root, img=img)
    finally:
        if router is not None:
            router.kill()
        collector.close()
        # the server processes' logs, kept beside the record
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with contextlib.suppress(OSError):
            shutil.copy(os.path.join(root, "servers.log"),
                        os.path.join(ROOT, "chiprun_out", "phase15_servers.log"))
        shutil.rmtree(root, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# -- phase 16: the load generator and the online model lifecycle ---------------

# 16a: the trace is recorded from phase 14's clients (requests in flight,
# seconds, image pool) and replayed at this offered rate: the replay's
# bodies are float32 JSON, ~4.2 MB a 256² image, which the replaying
# process encodes at ~0.3 s apiece on one CPU core (and the server
# decodes at ~0.2 s), so a few per second is what one Python process can
# offer; 12 s of recording (10 before phase 21: one run on the card
# recorded 104 POSTs in 10 s, short of the trace's 108)
P16A_IN_FLIGHT, P16A_RECORD_S, P16A_POOL, P16A_RATE = 8, 12.0, 16, 2.5
# the replayed trace: this many of the recording's POSTs, after the
# clients' first ones, which they all send at once; the fault comes late
# and lasts long enough that each window (before, during, after) holds
# at least P16A_MIN_WINDOW requests; the other chaos bounds are
# bin/smoke-chaos.sh's
# (100 since phase 19, 120 before: 30, 25 and 45 requests a window)
P16A_POSTS, P16A_MIN_WINDOW = 100, 20
P16A_CHAOS = ["--fault", "gateway.lane.kill=lane:0", "--fault-at", "12", "--fault-for", "10",
              "--settle-s", "4", "--recovery-s", "10", "--p99-factor", "2.0",
              "--max-shed-rate", "0.8"]
# 16b: serve-gateway --refit at its default width and bin/smoke-rollout.sh's
# flags; the poison's chunk count as smoke-rollout arms it
P16B_WIDTH = dict(d=256, hidden=512, depth=4)
P16B_REFIT = ["--buckets", "4,8", "--refit-interval-s", "0.5", "--refit-min-samples", "128",
              "--canary-fraction", "0.25"]
# (requests, seed) of the labeled runs, at 150 req/s, one after another
# until the rollback: a candidate solved from samples taken before the
# poison was armed can be promoted first, and the poisoned one after it
# then needs a third run's traffic to reach its verdict (seen on an
# H100: v2 promoted at 40.4 s, v3 in shadow when the second run ended)
P16B_LOADS = ((2500, 1), (2500, 2), (2500, 3))
P16B_RATE, P16B_FEEDBACK, P16B_HEAD_SEED, P16B_POISON_CHUNKS = 150, 0.5, 7, 16
# 16b's in-process lifecycle: feedback rows a candidate is solved from,
# the closed loop's requests a second (the drill's rate), probes
P16B_ROWS, P16B_PROBES = 400, 8
# 16c: open-loop lognormal arrivals into --self-gateway's gateway, the
# same workload run this many times over one gateway (three before phase
# 17; its p99 varied about tenfold between chip runs)
P16C_REQUESTS, P16C_RATE, P16C_RUNS = 2000, 400.0, 1
P16_RUN_S = 300.0  # a loadgen process's bound


def _finished(proc, what, timeout=P16_RUN_S):
    """A ``serve-loadgen`` process (a ``ServerProcess``) waited for: its
    exit code must be 0 (a green verdict); returns its one-line JSON
    documents merged."""
    rc = proc.proc.wait(timeout=timeout)
    time.sleep(0.2)  # the drain thread's last lines
    assert rc == 0, (what, rc, proc.lines[-40:])
    docs = [json.loads(ln) for ln in proc.lines if ln.startswith("{") and ln.endswith("}")]
    return {k: v for d in docs for k, v in d.items()}


def chaos_drill(dev, smi, feat, model, root, img=IMG, record_s=P16A_RECORD_S,
                in_flight=P16A_IN_FLIGHT, pool=P16A_POOL, rate=P16A_RATE, posts=P16A_POSTS,
                min_window=P16A_MIN_WINDOW):
    """Phase 16a: phase 4's chain and head (vocab 32, so B3 runs) behind
    ``Gateway`` and ``GatewayServer(request_log=FILE)``, phase 14's
    configuration but float32 instances: the loadgen replays a trace with
    float32 normals, which a uint8 server refuses (400) wherever a value
    is below 0 or past 255. A trace recorded from phase 14's uint8
    clients (``posts`` POSTs after the clients' simultaneous first
    ones), then ``serve-loadgen --target URL --trace FILE`` at ``rate``
    with a lane killed mid-run over ``POST /chaosz``: a green verdict,
    at least ``min_window`` requests before, during and after the
    fault, the injection on ``/metrics``, B1–B3 launched in this process
    during the replay."""
    from keystone_tpu_torch.gateway import Gateway, GatewayServer
    from keystone_tpu_torch.loadgen import trace as trace_mod

    rec = {"rate": rate}
    log_path = os.path.join(root, "requests.jsonl")
    t = time.perf_counter()
    gw = Gateway(model, buckets=BUCKETS, n_lanes=P14_LANES, pipeline_depth=P14_DEPTH,
                 max_delay_ms=P14_DELAY_MS, device_featurize=feat, device=dev,
                 warmup_example=np.zeros((img, img, 3), np.float32), name="phase16a")
    server = GatewayServer(gw, input_dtype=np.float32, request_log=log_path).start()
    url = server.url().rstrip("/")
    rec["build_s"] = time.perf_counter() - t
    try:
        images_path = os.path.join(root, "images.npy")
        np.save(images_path, np.random.default_rng(47).integers(0, 256, (pool, img, img, 3),
                                                                 dtype=np.uint8))
        clients = ClientProcess(url, images_path, record_s, in_flight,
                                os.path.join(root, "record.json"))
        clients.go()
        res = clients.result()
        assert all(r[1] == 200 for r in res["results"]), [r for r in res["results"] if r[1] != 200][:3]
        recorded = open(log_path).read().splitlines()
        n_recorded = len(recorded)
        seqs = list(dict.fromkeys(json.loads(ln)["post_seq"] for ln in recorded))
        assert len(seqs) >= in_flight + posts, (len(seqs), in_flight + posts)
        kept = set(seqs[in_flight : in_flight + posts])
        trace_path = os.path.join(root, "trace.jsonl")
        with open(trace_path, "w") as f:
            f.writelines(ln + "\n" for ln in recorded if json.loads(ln)["post_seq"] in kept)
        events = trace_mod.load_trace(trace_path)
        span = events[-1].ts - events[0].ts
        rec["trace"] = {"recorded_posts": len(seqs), "requests": len(events), "span_s": span,
                        "req_s": len(events) / span}
        speed = rate * span / len(events)
        rec["speed"] = speed
        log(f"16a: recorded {rec['trace']} from {in_flight} uint8 clients; replay at speed "
            f"{speed:.4f} = {rate} req/s")
        fired0 = metric_sum(url, "keystone_fault_injections_total", point="gateway.lane.kill")
        report_path = os.path.join(root, "chaos_verdict.json")
        _cuda.reset_launches()
        t = time.perf_counter()
        lg = ServerProcess(["serve-loadgen", "--target", url, "--trace", trace_path, "--speed",
                            repr(speed), "--report", report_path] + P16A_CHAOS,
                           os.path.join(root, "loadgen.log"), dev)
        out = _finished(lg, "16a serve-loadgen")
        rec["run_s"] = time.perf_counter() - t
        launches = dict(_cuda.LAUNCHES)
        verdict = json.load(open(report_path))
        stats = verdict["stats"]
        rec["verdict"] = {"passed": verdict["passed"],
                          "invariants": {i["name"]: i["detail"] for i in verdict["invariants"]}}
        rec["workload"] = out["workload"]
        ok = stats["by_status"].get("ok", 0)
        rec["stats"] = {k: stats[k] for k in (
            "issued", "by_status", "shed_rate", "duration_s", "max_behind_ms", "ready_recovery_s",
            "pre_fault_p99_ms", "during_fault_p99_ms", "post_fault_p99_ms", "p99_recovery_s",
            "recovered_p99_ms", "injections", "fault_windows")}
        rec["planned_req_s"] = stats["issued"] / (out["workload"]["duration_s"] / speed)
        # the server's request log: arrivals, and admission to result
        lines = [json.loads(ln) for ln in open(log_path).read().splitlines()[n_recorded:]]
        lat = [ln["latency_ms"] for ln in lines if ln["status"] == 200]
        # offered: the POSTs' issue times as the server stamped their
        # arrival; each fault window's requests, on the run's clock
        # (which starts with the first POST)
        arrivals = sorted({ln["post_seq"]: ln["ts"] for ln in lines}.values())
        rec["offered_req_s"] = (len(arrivals) - 1) / (arrivals[-1] - arrivals[0])
        fw = stats["fault_windows"][0]
        rel = [a - arrivals[0] for a in arrivals]
        rec["window_requests"] = {"before": sum(r < fw["t_arm"] for r in rel),
                                  "during": sum(fw["t_arm"] <= r < fw["t_clear"] for r in rel),
                                  "after": sum(r >= fw["t_clear"] for r in rel)}
        rec["served_req_s"] = len(lat) / (max(ln["ts"] + ln["latency_ms"] / 1e3 for ln in lines)
                                          - min(ln["ts"] for ln in lines))
        rec["server_latency_ms"] = {"p50": float(np.percentile(lat, 50)),
                                    "p99": float(np.percentile(lat, 99)), "requests": len(lat)}
        rec["fault_injections"] = metric_sum(url, "keystone_fault_injections_total",
                                          point="gateway.lane.kill") - fired0
        rec["launches"] = launches
        rec["launches_per_request"] = {k: v / max(ok, 1) for k, v in launches.items()}
        log(f"16a: verdict {rec['verdict']}; {rec['stats']}; offered {rec['offered_req_s']:.3f} "
            f"req/s (planned {rec['planned_req_s']:.3f}), served {rec['served_req_s']:.3f}; "
            f"requests a window {rec['window_requests']}; server-side admit -> result "
            f"{rec['server_latency_ms']}; injections {rec['fault_injections']}; launches "
            f"{launches} on {smi}")
        assert verdict["passed"], rec["verdict"]
        assert rec["fault_injections"] > 0 and stats["injections"]["gateway.lane.kill"] > 0, rec
        assert ok == stats["issued"], stats["by_status"]
        assert min(rec["window_requests"].values()) >= min_window, rec["window_requests"]
        if dev.type == "cuda":
            assert all(launches[k] > 0 for k in KERNEL_NAMES), launches
    finally:
        server.stop()
        gw.close()
    return rec


def _walk_subsequence(seen, want=("idle", "shadow", "canary", "promoted")):
    it = iter(s for s, _ in seen)
    return all(stage in it for stage in want)


def rollout_drill(dev, smi, root, width=P16B_WIDTH, refit=P16B_REFIT, loads=P16B_LOADS,
                  rate=P16B_RATE, settle_s=30.0):
    """Phase 16b over HTTP: ``serve-gateway --refit`` in a process of its
    own, fed by ``serve-loadgen --feedback-fraction --teacher`` (labels
    from a teacher whose head differs from the served model's): its
    ``/lifecyclez`` walks idle → shadow → canary → promoted; then
    ``lifecycle.refit.poison`` is armed over ``/chaosz`` and the next
    candidate rolls back (its reason on ``/lifecyclez``, the counter on
    ``/metrics``); every loadgen verdict green; SIGTERM, exit 0."""
    rec = {}
    log_path = os.path.join(root, "servers.log")
    w = [f"--{k}={v}" for k, v in width.items()]
    t = time.perf_counter()
    srv = ServerProcess(["serve-gateway", "--gateway-port", "0", "--refit"] + w + refit, log_path, dev)
    procs = [srv]
    try:
        url = srv.wait_json("listening")["listening"]
        rec["up_s"] = time.perf_counter() - t
        st = json.loads(http_get(url + "/lifecyclez")[1])["models"]["default"]
        assert (st["state"], st["version"]) == ("idle", 0), st
        teacher = f"hidden={width['hidden']},depth={width['depth']},head_seed={P16B_HEAD_SEED}"

        def start(n, seed):
            p = ServerProcess(["serve-loadgen", "--target", url, f"--d={width['d']}", "--synthetic",
                               str(n), "--rate", str(rate), "--seed", str(seed),
                               "--feedback-fraction", str(P16B_FEEDBACK), "--teacher", teacher,
                               "--report", os.path.join(root, f"rollout{seed}.json")],
                              os.path.join(root, "loadgen.log"), dev)
            procs.append(p)
            return p

        # the labeled runs one after another until the poisoned candidate
        # rolled back (the first promotion arms the poison); the policy
        # ticks on for settle_s after the last run's traffic ends
        t0 = time.perf_counter()
        pending, runs = list(loads), []
        current = start(*pending.pop(0))
        seen, promoted, rolled, ended = [], None, None, None
        while rolled is None and (ended is None or time.perf_counter() - ended < settle_s):
            st = json.loads(http_get(url + "/lifecyclez")[1])["models"]["default"]
            now = round(time.perf_counter() - t0, 3)
            if (st["promotions"] >= 1 and st["state"] not in ("canary", "promoted")
                    and all(s != "promoted" for s, _ in seen)):
                # the controller's own record: its promotion counter moves
                # at the promoted transition, which the next candidate's
                # stages can follow within one poll interval
                seen.append(("promoted", now))
            if not seen or seen[-1][0] != st["state"]:
                seen.append((st["state"], now))
            if promoted is None and st["promotions"] >= 1:
                promoted = dict(st, t_s=now)
                http_post(url + "/chaosz", {"arm": {"point": "lifecycle.refit.poison",
                                                    "count": P16B_POISON_CHUNKS}})
            elif promoted is not None and st["state"] == "rolled_back":
                # the rollback as polled: the next candidate may start
                # on the controller's next tick, before a second read
                rolled = dict(st, t_s=now)
            elif promoted is not None and metric_sum(url, "keystone_lifecycle_rollbacks_total") >= 1:
                # the state as of the counter: the snapshot above may
                # predate the rollback the counter shows
                st = json.loads(http_get(url + "/lifecyclez")[1])["models"]["default"]
                rolled = dict(st, t_s=round(time.perf_counter() - t0, 3))
                if seen[-1][0] != st["state"]:
                    seen.append((st["state"], rolled["t_s"]))
            if current is not None and current.proc.poll() is not None:
                runs.append(_finished(current, "16b serve-loadgen"))
                current = start(*pending.pop(0)) if pending else None
                if current is None:
                    ended = time.perf_counter()
            time.sleep(0.2)
        if current is not None:
            runs.append(_finished(current, "16b serve-loadgen"))
        rec["stages_seen"] = seen
        rec["promoted"] = promoted
        rec["rolled_back"] = rolled
        rec["loadgen"] = [{"workload": r["workload"], "feedback": r["feedback"]} for r in runs]
        rec["rollbacks"] = {reason: metric_sum(url, "keystone_lifecycle_rollbacks_total", reason=reason)
                            for reason in ("accuracy", "shadow_diff", "canary_errors", "slo_burn")}
        rec["poison_fired"] = metric_sum(url, "keystone_fault_injections_total",
                                      point="lifecycle.refit.poison")
        text = http_get(url + "/metrics")[1].decode()
        rec["families"] = sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                                  if ln.startswith("keystone_lifecycle_")})
        log(f"16b: /lifecyclez stages {seen}; promoted {promoted}; rolled back {rolled}; "
            f"rollbacks {rec['rollbacks']}; loadgen {rec['loadgen']} on {smi}")
        assert promoted is not None and _walk_subsequence(seen), seen
        assert promoted["errors"]["candidate"] < promoted["errors"]["incumbent"], promoted
        assert rolled is not None and rolled["state"] == "rolled_back", (rolled, seen)
        assert rolled["last_reason"] in ("accuracy", "shadow_diff"), rolled
        assert rec["rollbacks"][rolled["last_reason"]] >= 1 and rec["poison_fired"] > 0, rec
        for fam in ("keystone_lifecycle_state", "keystone_lifecycle_version",
                    "keystone_lifecycle_refit_samples_total", "keystone_lifecycle_shadow_pairs_total",
                    "keystone_lifecycle_canary_requests_total", "keystone_lifecycle_promotions_total",
                    "keystone_lifecycle_rollbacks_total"):
            assert fam in rec["families"], (fam, rec["families"])
        rc, s = srv.stop()
        rec["exit"] = {"code": rc, "s": s}
        assert rc == 0, srv.lines[-5:]
        return rec
    finally:
        for p in procs:
            p.kill()


def lifecycle_in_process(dev, smi, width=P16B_WIDTH, rows=P16B_ROWS, probes=P16B_PROBES,
                         rate=P16B_RATE):
    """Phase 16b in this process: ``serve-gateway --refit``'s gateway and
    controller (its default width, buckets (4, 8), 2 lanes), ticked by
    hand under a closed loop of ``rate`` requests a second: the seconds of
    a candidate's solve and build and of each ``swap_model``, outputs
    after a post-promotion rollback bitwise equal to the incumbent's
    (probes one at a time, load paused: one bucket), a poisoned candidate
    rolled back, and ``memory_allocated`` after the last rollback within
    one version's graph pools of where it stood before the first
    candidate."""
    from keystone_tpu_torch.gateway import Gateway
    from keystone_tpu_torch.lifecycle.controller import LifecycleController
    from keystone_tpu_torch.lifecycle.teacher import teacher_labels
    from keystone_tpu_torch.loadgen import faults
    from keystone_tpu_torch.serving.bench import affine_head, build_split_pipeline

    on_card = dev.type == "cuda"
    d, hidden, depth = width["d"], width["hidden"], width["depth"]
    base, W0, b0 = build_split_pipeline(d=d, hidden=hidden, depth=depth, device=dev)

    def head(W, b):
        return affine_head(W, b, device=dev)

    gw = Gateway(base.and_then(head(W0, b0)), buckets=(4, 8), n_lanes=2, device=dev,
                 warmup_example=torch.zeros(d), name="phase16b")
    ctl = LifecycleController(gw, base=base, head_builder=head, feature_dim=hidden, out_dim=d,
                              name="phase16b", canary_fraction=0.25, min_refit_samples=128)
    rng = np.random.default_rng(53)
    xs = rng.standard_normal((64, d)).astype(np.float32)
    probe_x = rng.standard_normal((probes, d)).astype(np.float32)
    stop, paused, served = threading.Event(), threading.Event(), [0]

    def load():
        k = 0
        while not stop.is_set():
            if paused.is_set():
                time.sleep(0.01)
                continue
            gw.predict(xs[k % len(xs)]).result(timeout=60)
            served[0] += 1
            k += 1
            time.sleep(1.0 / rate)

    def outputs():
        paused.set()
        time.sleep(0.1)  # the loop's last request resolved
        try:
            return np.stack([np.asarray(gw.predict(x).result(timeout=60)) for x in probe_x])
        finally:
            paused.clear()

    def labeled(n, seed):
        X = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
        return X, teacher_labels(X, d, hidden, depth, head_seed=P16B_HEAD_SEED)

    def tick_until(stage, bound_s=60.0):
        t = time.perf_counter()
        while time.perf_counter() - t < bound_s:
            time.sleep(0.5)
            t1 = time.perf_counter()
            st = ctl.tick()
            tick_s = time.perf_counter() - t1
            if st["state"] == stage:
                return st, tick_s
        raise AssertionError(f"16b: no {stage} within {bound_s} s: {ctl.status()}")

    rec = {}
    loader = threading.Thread(target=load, name="phase16b-load", daemon=True)
    try:
        if on_card:
            # cuBLAS keeps a 32 MiB workspace for each (thread's handle,
            # stream) that ran a product, for the process's life (captured
            # graphs hold its address: it is never freed under them), and
            # engines take their streams from PyTorch's pool of 32: touch
            # every pooled stream and the current one on this thread
            # (which captures every graph and runs the refit below) before
            # the baseline, so that no first-use workspace counts as growth
            a = torch.ones(8, 8, device=dev)
            a @ a
            for _ in range(64):
                with torch.cuda.stream(torch.cuda.Stream(dev)):
                    a @ a
            torch.cuda.synchronize(dev)
            mem0 = torch.cuda.memory_allocated(dev)
            res0 = torch.cuda.memory_reserved(dev)
        pools = sum(g["pool_bytes"] for lane in gw.pool.lanes for g in lane.engine.graph_report())
        rec["version_pool_bytes"] = pools
        incumbent_out = outputs()
        loader.start()
        ctl.add_feedback(*labeled(rows, 1))
        t = time.perf_counter()
        st = ctl.tick()
        rec["candidate_build_s"] = time.perf_counter() - t  # drain, solve, build + captures
        assert st["state"] == "shadow", st
        st, rec["canary_tick_s"] = tick_until("canary")
        st, rec["promote_swap_s"] = tick_until("promoted")  # swap_model: 2 lanes' captures
        rec["promoted"] = {"version": st["version"], "errors": st["errors"]}
        promoted_out = outputs()
        assert not np.array_equal(promoted_out, incumbent_out)
        t = time.perf_counter()
        st = ctl.force_rollback("phase16b")
        rec["rollback_swap_s"] = time.perf_counter() - t
        assert st["state"] == "rolled_back", st
        restored = outputs()
        rec["rollback_bitwise_equal"] = bool(np.array_equal(restored, incumbent_out))
        rec["rollback_max_abs_diff"] = float(np.abs(restored - incumbent_out).max())
        # a poisoned candidate: caught within one tick of its shadow start
        faults.arm("lifecycle.refit.poison", count=P16B_POISON_CHUNKS)
        ctl.add_feedback(*labeled(rows, 2))
        t = time.perf_counter()
        st = ctl.tick()
        rec["poisoned_build_s"] = time.perf_counter() - t
        assert st["state"] == "shadow", st
        st = ctl.tick()
        rec["poisoned"] = {"state": st["state"], "reason": st["last_reason"], "errors": st["errors"]}
        assert (st["state"], st["last_reason"]) == ("rolled_back", "accuracy"), st
        faults.disarm("lifecycle.refit.poison")
        stop.set()
        loader.join(timeout=60)
        rec["requests_served"] = served[0]
        if on_card:
            torch.cuda.synchronize(dev)
            rec["memory"] = {"allocated_before": mem0,
                             "allocated_after": torch.cuda.memory_allocated(dev),
                             "reserved_before": res0,
                             "reserved_after": torch.cuda.memory_reserved(dev)}
        log(f"16b in process: {rec} on {smi}")
        assert rec["rollback_bitwise_equal"], rec["rollback_max_abs_diff"]
        if on_card:
            grew = rec["memory"]["allocated_after"] - rec["memory"]["allocated_before"]
            assert grew <= pools, (grew, pools)
    finally:
        stop.set()
        faults.disarm("lifecycle.refit.poison")
        ctl.close()
        gw.close()
    return rec


def open_loop(dev, smi, requests=P16C_REQUESTS, rate=P16C_RATE, runs=P16C_RUNS):
    """Phase 16c: ``serve-loadgen --self-gateway --synthetic N --arrivals
    lognormal --rate R`` in this process on the card (its green verdict),
    then the same generator over the same gateway (``--self-gateway``'s:
    the demo model at d 64, buckets (4, 16), 2 lanes) ``runs`` times with
    the reports kept: open-loop p50/p99 of each run."""
    from keystone_tpu_torch.gateway import Gateway
    from keystone_tpu_torch.loadgen import cli as loadgen_cli
    from keystone_tpu_torch.loadgen import invariants, runner
    from keystone_tpu_torch.loadgen import trace as trace_mod
    from keystone_tpu_torch.serving.bench import build_pipeline

    argv = ["--self-gateway", "--synthetic", str(requests), "--arrivals", "lognormal", "--rate",
            str(rate)]
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = loadgen_cli.main(argv, device=dev)
    rec = {"cli_s": time.perf_counter() - t}
    text = out.getvalue()
    verdict = json.loads(text[text.index("\n") + 1:])
    rec["cli_verdict"] = {"passed": verdict["passed"], "stats": {
        k: verdict["stats"][k] for k in ("issued", "by_status", "duration_s", "max_behind_ms")}}
    assert rc == 0 and verdict["passed"], text[-2000:]
    d = 64  # --self-gateway's defaults
    gw = Gateway(build_pipeline(d=d, hidden=d, depth=2, device=dev), buckets=(4, 16), n_lanes=2,
                 warmup_example=torch.zeros(d), device=dev, name="phase16c")
    try:
        events = trace_mod.synthesize(requests, arrivals="lognormal", rate=rate, shape=(d,))
        rec["open_loop"] = []
        for _ in range(runs):
            report = runner.LoadGenerator(runner.InprocTarget(gw, default_shape=(d,))).run(events)
            lat = report.latencies()
            check = invariants.InvariantChecker().check(report)
            rec["open_loop"].append({
                "requests": len(lat), "offered_req_s": requests / (events[-1].ts or 1.0),
                "served_req_s": len(lat) / report.duration_s,
                "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                "max_behind_ms": report.stats()["max_behind_ms"], "passed": check.passed})
            assert check.passed and len(lat) == requests, check.to_json()
        log(f"16c: {rec} on {smi}")
    finally:
        gw.close()
    return rec


def loadgen_and_lifecycle(dev, smi, feat, model, img=IMG, chaos=None, rollout=None, inproc=None,
                          openloop=None):
    """Phase 16: 16a (``chaos_drill``), 16b (``rollout_drill`` over HTTP,
    ``lifecycle_in_process``) and 16c (``open_loop``). The ``chaos``,
    ``rollout``, ``inproc`` and ``openloop`` dicts override those
    functions' sizes. To rehearse it on the CPU at a small size, with a
    48² chain and head: ``loadgen_and_lifecycle(torch.device("cpu"),
    "cpu", feat, model, img=48, chaos=dict(record_s=6, rate=4),
    rollout=dict(width=dict(d=24, hidden=32, depth=3), refit=["--buckets",
    "4,8", "--refit-interval-s", "0.5", "--refit-min-samples", "32",
    "--canary-fraction", "0.25"], loads=((1500, 1), (1500, 2))),
    inproc=dict(width=dict(d=24, hidden=32, depth=3)),
    openloop=dict(requests=300, rate=200))`` (about 90 s)."""
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "tmp", "phase16")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rec = {"card": smi}
    try:
        t = time.perf_counter()
        rec["chaos"] = chaos_drill(dev, smi, feat, model, root, img=img, **(chaos or {}))
        rec["chaos"]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rec["rollout"] = rollout_drill(dev, smi, root, **(rollout or {}))
        rec["rollout"]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rec["lifecycle"] = lifecycle_in_process(dev, smi, **(inproc or {}))
        rec["lifecycle"]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rec["open_loop"] = open_loop(dev, smi, **(openloop or {}))
        rec["open_loop"]["phase_s"] = time.perf_counter() - t
    finally:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        for name in ("servers.log", "loadgen.log"):
            with contextlib.suppress(OSError):
                shutil.copy(os.path.join(root, name),
                            os.path.join(ROOT, "chiprun_out", f"phase16_{name}"))
        shutil.rmtree(root, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# -- phase 17: cold start, model sharding and elasticity ----------------------

# the flagship gateway's flags in 17b/c and the autoscaler's replicas (the
# autoscaler's own defaults for the model: d 64 is ignored under
# --device-featurize, hidden 64, depth 2; one lane)
P17_GATEWAY = ["--device-featurize", "flagship", "--buckets", "8,64", "--lanes", "1",
               "--hidden", "64", "--depth", "2"]
P17_IMAGES = 64  # images answered by every engine held bit for bit
P17_UP_S = 240.0  # a start's bound (nvcc included when cold)
# 17d: the autoscaler's policy over a step of uint8 256² images through its
# router: RATE_HIGH req/s (over one replica's JSON-bound capacity, 12.6–17.1
# req/s in phases 14–15) for HIGH_S, then RATE_LOW for LOW_S. On the H100's
# host one serve-loadgen issues such bodies at about 17 req/s, so a 30 s
# step reached the router 10–18 s late, near one replica's capacity; the
# policy reads latency alone, two replicas held that load at a p99 of
# 240–380 ms, and a scale-down while it lasted left one replica under it,
# which scaled straight back up. A scale-down takes 10 cold ticks. A 20 s
# step ended before the second replica (decided about 16 s in, up 9 s
# later) had load to take: it served 2 requests in one run and none in
# another, where the scale-down retired it first; a 30 s step lasts past
# its start, and ends before 10 cold ticks can pass with two replicas.
P17_SLO_MS = 1000
P17_RATE_HIGH, P17_HIGH_S, P17_RATE_LOW, P17_LOW_S = 24, 30, 2, 20
P17_POLICY = ["--interval", "1", "--up-consecutive", "2", "--up-cooldown", "5",
              "--down-consecutive", "10", "--down-cooldown", "10", "--slo-fast-window", "10",
              "--slo-sample-interval", "1"]
# 17e: serve-capacity-plan over the demo model, its replicas in this
# process, at 17d's objective: the plan derives the autoscaler's policy.
# (A 100 ms objective broke in every cell of one run on the card, 133.5 ms
# at two replicas and 89 req/s, where other runs held it at 24–80 ms: the
# host's share of a p99 varies from machine to machine.)
# 100 requests a cell since phase 19 (200 before)
P17_PLAN = ["--synthetic", "100", "--rate", "50", "--replicas", "1,2", "--speeds", "1,2",
            "--slo-latency-ms", str(P17_SLO_MS), "--d", "32", "--hidden", "32", "--depth", "2",
            "--buckets", "4"]


def phase4_head_weights(feat_dim):
    """Phase 4's seeded head: W (feat_dim, CLASSES) and the intercept."""
    rng = np.random.default_rng(11)
    W = (rng.standard_normal((feat_dim, CLASSES)) / np.sqrt(feat_dim)).astype(np.float32)
    icpt = (rng.standard_normal(CLASSES) * 0.01).astype(np.float32)
    return W, icpt


def phase4_chain(dev, img=IMG):
    """Phase 4's chain and head (the seeds and draws of ``serve``)."""
    feat, feat_dim = build_flagship_featurize_pipeline(device=dev, **dict(CONF, img=img))
    return feat, model_head(*phase4_head_weights(feat_dim), TOP_K, dev)


def startup_split(args):
    """In a fresh process (``python3 chip_smoke.py --startup-split JSON``):
    phase 4's engine at buckets (8, 64) built cold (no store; with a fresh
    ``$KEYSTONE_CUDA_BUILD_DIR`` nvcc builds the kernels) or from the
    store at ``args["store"]``, then the images at ``args["images"]``
    answered and saved to ``args["out"]``. Prints one JSON line: the
    start's split in seconds, the store's report, the launches of the
    answering replay."""
    from keystone_tpu_torch.gateway.http import _process_age_s
    from keystone_tpu_torch.serving.aot import AotStore

    split = {"import": _process_age_s()}
    dev = torch.device(args["device"])
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    split["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    feat, model = phase4_chain(dev, args["img"])
    split["model"] = time.perf_counter() - t
    store = AotStore(args["store"]) if args.get("store") else None
    engine = model.compiled(BUCKETS, featurize=feat, device=dev, aot_store=store or False)
    img = args["img"]
    if store is None:
        t = time.perf_counter()
        if dev.type == "cuda":
            _cuda.build()
        split["kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        for _, op in engine._operator_nodes():
            op.operators(img, img, dev)
        split["operators"] = time.perf_counter() - t
    t = time.perf_counter()
    capture_s = engine.warmup(example=np.zeros((img, img, 3), np.uint8))
    split["warmup"] = time.perf_counter() - t
    if store is not None:
        split["kernels"] = engine.aot_libraries_s
        split["warmup"] -= engine.aot_libraries_s
    images = np.load(args["images"])
    _cuda.reset_launches()
    out = engine.apply(images, sync=True)
    launches = dict(_cuda.LAUNCHES)
    np.save(args["out"], out.cpu().numpy())
    print(json.dumps({"split": split, "capture_s": {str(b): v for b, v in capture_s.items()},
                      "aot": {str(b): v for b, v in engine.aot_report().items()},
                      "libraries": engine.aot_libraries, "nvcc_s": dict(_cuda.BUILD_SECONDS),
                      "store": None if store is None else store.status(), "launches": launches,
                      "compile_count": engine.metrics.compile_count}), flush=True)


def _split_process(dev, root, name, **args):
    """``startup_split`` in a fresh ``python3`` with a build directory of
    its own; returns its record with the process's wall seconds."""
    build = os.path.join(root, f"build-{name}")
    out = os.path.join(root, f"{name}.npy")
    doc = dict(device=dev.type, out=out, images=os.path.join(root, "images.npy"), **args)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--startup-split",
                           json.dumps(doc)], cwd=ROOT, capture_output=True, text=True,
                          timeout=P17_UP_S, env={**os.environ, "KEYSTONE_CUDA_BUILD_DIR": build})
    wall = time.perf_counter() - t
    assert proc.returncode == 0, (name, proc.stdout[-2000:], proc.stderr[-4000:])
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec["wall_s"] = wall
    rec["outputs"] = np.load(out)
    return rec


def aot_round_trip(dev, smi, feat, model, root, img=IMG):
    """Phase 17a/b: the start-up split cold and from the store, the AOT
    round trip of phase 4's engine (in process, a fresh process from the
    store, a corrupted entry), ``serve-aot-build``, and
    ``serve-gateway --aot-cache`` started twice with fresh build
    directories (cold, then from the store)."""
    from keystone_tpu_torch.observability.registry import MetricsRegistry
    from keystone_tpu_torch.serving.aot import AotStore

    rec = {}
    images = np.random.default_rng(31).integers(0, 256, (P17_IMAGES, img, img, 3), dtype=np.uint8)
    np.save(os.path.join(root, "images.npy"), images)
    engine_dir = os.path.join(root, "store-engine")
    # -- the saving engine, in this process
    store = AotStore(engine_dir, registry=MetricsRegistry())
    saver = model.compiled(BUCKETS, featurize=feat, device=dev, aot_store=store)
    t = time.perf_counter()
    saver.warmup(example=np.zeros((img, img, 3), np.uint8))
    rec["save_s"] = time.perf_counter() - t
    assert {b: v["status"] for b, v in saver.aot_report().items()} == {b: "saved" for b in BUCKETS}
    want = saver.apply(images, sync=True).cpu().numpy()
    rec["saved"] = store.status()
    entry_bytes = [os.path.getsize(store.path_for(k)) for k in store.entries()]
    rec["entry_bytes"] = entry_bytes
    log(f"17b saved {len(entry_bytes)} entries ({entry_bytes} B) and "
        f"{store.status()['libraries']} kernel libraries in {rec['save_s']:.3f} s on {smi}")
    # -- fresh processes: cold (nvcc, operators built), then from the store
    cold = _split_process(dev, root, "cold", img=img)
    warm = _split_process(dev, root, "store", img=img, store=engine_dir)
    for name, r in (("cold", cold), ("store", warm)):
        rec[name] = {k: v for k, v in r.items() if k != "outputs"}
        log(f"17a {name} start of phase 4's engine: {r['split']} (process {r['wall_s']:.3f} s; "
            f"nvcc {r['nvcc_s']}; captures {r['capture_s']}) on {smi}")
    assert warm["store"]["hits"] == len(BUCKETS), warm["store"]
    assert warm["store"]["errors"] == 0 and warm["nvcc_s"] == {}, warm
    if dev.type == "cuda":
        assert set(warm["libraries"].values()) == {"loaded"}, warm["libraries"]
        assert cold["nvcc_s"], cold
        per_replay = {"sift_bin_sample": 4, "plane_sandwich": 1, "fisher_vector_stats": 2}
        replays = -(-P17_IMAGES // BUCKETS[-1])
        want_launches = {k: v * replays for k, v in per_replay.items()}
        assert warm["launches"] == want_launches == cold["launches"], (warm["launches"], cold)
    assert np.array_equal(warm["outputs"], want), "the engine from the store answered otherwise"
    assert np.array_equal(cold["outputs"], want), "the cold engine answered otherwise"
    # -- a corrupted entry: counted, rebuilt on the card, the answers equal
    key = next(k for k in store.entries() if store.read_meta(k)["bucket"] == BUCKETS[0])
    with open(store.path_for(key), "r+b") as f:
        f.seek(os.path.getsize(store.path_for(key)) // 2)
        f.truncate()
        f.write(b"\0" * 64)
    errors = store.errors
    again = model.compiled(BUCKETS, featurize=feat, device=dev, aot_store=store)
    again.warmup(example=np.zeros((img, img, 3), np.uint8))
    report = again.aot_report()
    rec["corrupted"] = {"report": {str(b): v for b, v in report.items()},
                        "errors": store.errors - errors}
    assert report[BUCKETS[0]] == {"status": "error", "fallback": "saved"}, report
    assert report[BUCKETS[-1]]["status"] == "hit" and store.errors == errors + 1, report
    assert np.array_equal(again.apply(images, sync=True).cpu().numpy(), want)
    assert np.array_equal(again.apply(images[:BUCKETS[0]], sync=True).cpu().numpy(),
                          want[:BUCKETS[0]])
    log(f"17b corrupted entry of bucket {BUCKETS[0]}: {rec['corrupted']} on {smi}")
    for e in (saver, again):
        e.release_graphs()
    # -- serve-aot-build fills a store for the gateway's flags (the tests
    # hold a second run to hits)
    t = time.perf_counter()
    proc = ServerProcess(["serve-aot-build", "--img", str(img), *P17_GATEWAY[:4], *P17_GATEWAY[6:],
                          "--aot-cache", os.path.join(root, "store-build")],
                         os.path.join(root, "servers.log"), dev)
    rc = proc.proc.wait(timeout=P17_UP_S)
    time.sleep(0.2)
    proc.kill()
    doc = json.loads(next(ln for ln in reversed(proc.lines) if ln.startswith("{")))
    rec["aot_build"] = {"rc": rc, "s": time.perf_counter() - t, "libraries": doc["libraries"],
                        "statuses": {b: v["status"] for b, v in doc["aot"].items()}}
    assert rc == 0 and set(rec["aot_build"]["statuses"].values()) == {"saved"}, proc.lines[-5:]
    log(f"17b serve-aot-build: {rec['aot_build']} on {smi}")
    # -- serve-gateway --aot-cache, started twice with fresh build dirs
    rec["gateway"] = []
    answers = []
    gateway_dir = os.path.join(root, "store-gateway")
    probe = {"instances": [im.tolist() for im in images[:2]]}
    for n in range(2):
        srv = ServerProcess(["serve-gateway", "--gateway-port", "0", "--img", str(img),
                             *P17_GATEWAY, "--aot-cache", gateway_dir],
                            os.path.join(root, "servers.log"), dev,
                            env={"KEYSTONE_CUDA_BUILD_DIR": os.path.join(root, f"build-gw{n}")})
        try:
            first = srv.wait_json("listening", timeout=P17_UP_S)
            up_s = time.perf_counter() - srv.started
            url = first["listening"]
            hits = metric_sum(url, "keystone_aot_cache_hits_total")
            code, doc = http_post(url + "/predict", probe)
            assert code == 200, doc
            answers.append(doc["predictions"])
            rc, _ = srv.stop()
            drained = srv.wait_json("drained")
        finally:
            srv.kill()
        assert rc == 0
        rec["gateway"].append({"up_s": up_s, "start_s": first["start_s"], "hits": hits,
                               "launches": drained["launches"]})
        log(f"17b serve-gateway --aot-cache start {n + 1} ({('cold', 'from the store')[n]}): up in "
            f"{up_s:.3f} s, split {first['start_s']}, keystone_aot_cache_hits_total {hits} on {smi}")
    assert rec["gateway"][0]["hits"] == 0 and rec["gateway"][1]["hits"] == len(BUCKETS)
    assert answers[0] == answers[1]
    rec["gateway_answers"] = answers[1]
    return rec, gateway_dir


def sharded_gateway(dev, smi, feat, model, root, gateway_dir, answers, img=IMG):
    """Phase 17c: ``Gateway(param_sharding=True)`` over phase 4's chain on
    a (1, 1) mesh against the unsharded gateway; ``serve-gateway
    --shard-model --mesh-model 1`` against 17b's unsharded answers (and
    its own store entries: a sharded engine never shares one); and
    ``--mesh-model 2`` exits non-zero with its reason."""
    from keystone_tpu_torch.gateway import Gateway
    from keystone_tpu_torch.gateway import http as ghttp
    from keystone_tpu_torch.observability.registry import MetricsRegistry
    from keystone_tpu_torch.serving import sharding

    rec = {}
    images = np.load(os.path.join(root, "images.npy"))
    sharding.set_mesh(sharding.make_mesh(n_model=1, devices=[dev]))
    outs = {}
    try:
        for shard in (True, None):
            gw = Gateway(model, buckets=BUCKETS, n_lanes=1, device_featurize=feat, device=dev,
                         param_sharding=shard, warmup_example=np.zeros((img, img, 3), np.uint8),
                         registry=MetricsRegistry(), name=f"p17c-{shard}")
            with gw:
                futs = [gw.predict(im) for im in images]
                outs[shard] = np.stack([np.asarray(f.result(timeout=120)) for f in futs])
                engine = gw.pool.lanes[0].engine
                if shard:
                    rec["specs"] = {k: str(v) for k, v in engine.param_sharding.items()}
                    rec["placed_bytes"] = {str(k): v for k, v in sharding.placed_shard_bytes(
                        engine._placed_params).items()}
                    rec["mesh"] = sharding.current_mesh().shape
            engine.release_graphs()
    finally:
        sharding.set_mesh(None)
    assert np.array_equal(outs[True], outs[None])
    log(f"17c sharded gateway over phase 4's chain: specs {rec['specs']}, placed "
        f"{rec['placed_bytes']} B, mesh {rec['mesh']}; {P17_IMAGES} answers equal to the "
        f"unsharded gateway's on {smi}")
    srv = ServerProcess(["serve-gateway", "--gateway-port", "0", "--img", str(img), *P17_GATEWAY,
                         "--shard-model", "--mesh-model", "1", "--aot-cache", gateway_dir],
                        os.path.join(root, "servers.log"), dev)
    try:
        first = srv.wait_json("listening", timeout=P17_UP_S)
        url = first["listening"]
        code, doc = http_post(url + "/predict", {"instances": [im.tolist() for im in images[:2]]})
        assert code == 200 and doc["predictions"] == answers, doc
        rec["cli"] = {"mesh": first["mesh"], "specs": first["sharding"], "start_s": first["start_s"],
                      "hits": metric_sum(url, "keystone_aot_cache_hits_total"),
                      "misses": metric_sum(url, "keystone_aot_cache_misses_total")}
        assert srv.stop()[0] == 0
    finally:
        srv.kill()
    assert rec["cli"]["mesh"] == {"data": 1, "model": 1} and rec["cli"]["hits"] == 0
    log(f"17c serve-gateway --shard-model --mesh-model 1: {rec['cli']} on {smi}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ghttp.main(["--shard-model", "--mesh-model", "2", "--img", str(img), *P17_GATEWAY],
                        device=dev)
    rec["mesh2"] = {"rc": rc, "out": out.getvalue().strip()}
    assert rc != 0 and "needs 2 devices" in out.getvalue(), rec["mesh2"]
    sharding.set_mesh(None)
    log(f"17c --mesh-model 2: exit {rc}: {rec['mesh2']['out']} on {smi}")
    return rec


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def autoscale_drill(dev, smi, root, gateway_dir, img=IMG, rate_high=P17_RATE_HIGH,
                    high_s=P17_HIGH_S, rate_low=P17_RATE_LOW, low_s=P17_LOW_S, linger_s=0.0):
    """Phase 17d: ``serve-autoscale`` (1–2 flagship replicas sharing 17b's
    store) under ``serve-loadgen --ramp`` of uint8 images through its
    router: a scale_up, the second replica serving, no failed request, a
    drain-retired replica after the load drops, SIGTERM draining every
    child; each replica's start seconds and its B1/B2 launches (from the
    ``{"drained": ...}`` line in its log). ``linger_s`` keeps the
    autoscaler running that long after the retire, so that a late scale_up
    shows (``--autoscale-runs``)."""
    rec = {}
    rdir = os.path.join(root, "replicas")
    auto = ServerProcess(["serve-autoscale", "--router-port", "0", "--min-replicas", "1",
                          "--max-replicas", "2", "--slo-latency-ms", str(P17_SLO_MS), *P17_POLICY,
                          "--buckets", "8,64", "--hidden", "64", "--depth", "2",
                          "--gateway-arg=--device-featurize=flagship", f"--gateway-arg=--img={img}",
                          "--aot-cache", gateway_dir, "--replica-log-dir", rdir],
                         os.path.join(root, "autoscale.log"), dev)
    lg = None

    def stamped_events():
        """The autoscaler's events, each stamped with its arrival."""
        return [dict(doc, t=t) for t, doc in list(auto.arrivals) if "event" in doc]

    def wait_event(pred, timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            hit = next((e for e in stamped_events() if pred(e)), None)
            if hit is not None:
                return hit
            time.sleep(0.2)
        raise AssertionError(f"17d: no such event in {timeout} s: {stamped_events()[-10:]}")

    try:
        router = auto.wait_json("listening", timeout=P17_UP_S)["listening"]
        first = wait_event(lambda e: e["event"] == "replica_started", P17_UP_S)
        rec["first_up_s"] = first["t"]
        t0 = time.perf_counter() - auto.started
        lg = ServerProcess(["serve-loadgen", "--target", router, "--ramp",
                            f"{rate_high}:{high_s},{rate_low}:{low_s}", "--payload-dtype", "uint8",
                            "--payload-shape", f"{img},{img},3", "--max-outstanding", "1024",
                            "--report", os.path.join(root, "ramp.json")],
                           os.path.join(root, "loadgen.log"), dev)
        wait_event(lambda e: e.get("action") == "scale_up", high_s + 60)
        second = wait_event(lambda e: e["event"] == "replica_started" and e["name"] != first["name"],
                            P17_UP_S)
        # the decision's event follows the launch it waited for: the
        # decision itself came the replica's start seconds before it
        rec["scale_up_decided_s"] = second["t"] - second["start_s"] - t0
        rec["second_up_s"] = second["t"] - t0
        # the second replica serves: ready on the router, and answering
        deadline = time.perf_counter() + 60
        served2 = 0
        while time.perf_counter() < deadline and served2 == 0:
            try:
                served2 = requests_ok(second["url"])
            except OSError as e:  # retired or dead before it served
                events = [(round(ev["t"] - t0, 1), ev.get("action", ev["event"]), ev.get("reason"),
                           ev.get("offered_rps"), ev.get("running")) for ev in stamped_events()]
                raise AssertionError(f"17d: the second replica stopped answering before it "
                                     f"served ({e!r}); events, s from the load's start: "
                                     f"{events}") from e
            time.sleep(1)
        rec["second_served_during_load"] = served2
        assert served2 > 0, "17d: the second replica served nothing"
        rc = lg.proc.wait(timeout=high_s + low_s + 300)
        rec["loadgen_rc"] = rc
        verdict = json.load(open(os.path.join(root, "ramp.json")))
        stats = verdict["stats"]
        rec["ramp"] = {k: stats.get(k) for k in ("issued", "by_status", "duration_s",
                                                  "max_behind_ms")}
        rec["ramp"]["verdict_passed"] = verdict["passed"]
        assert stats["by_status"] == {"ok": stats["issued"]}, stats["by_status"]
        down = wait_event(lambda e: e.get("action") == "scale_down", 120)
        rec["scale_down_s"] = down["t"] - t0
        retired = wait_event(lambda e: e["event"] == "replica_retired", 90)
        assert retired.get("drained") is True, retired
        rec["retired"] = retired
        time.sleep(linger_s)
        t = time.perf_counter()
        rc, _ = auto.stop(timeout=120)
        rec["sigterm"] = {"rc": rc, "s": time.perf_counter() - t}
        assert rc == 0
    finally:
        if lg is not None:
            lg.kill()
        if auto.proc.poll() is None:
            # a failure above: SIGTERM first, so that the autoscaler
            # retires its replicas
            with contextlib.suppress(Exception):
                auto.stop(timeout=120)
        auto.kill()
        time.sleep(1.0)
        events = stamped_events()
        pids = {e["name"]: e["pid"] for e in events if e["event"] == "replica_started"}
        rec["left_running"] = sorted(n for n, pid in pids.items() if _pid_alive(pid))
        for name in rec["left_running"]:  # no replica may hold the card past here
            with contextlib.suppress(OSError):
                os.kill(pids[name], 9)
    assert not rec["left_running"], rec["left_running"]
    rec["starts"] = {e["name"]: e["start_s"] for e in events if e["event"] == "replica_started"}
    rec["decisions"] = dict(Counter(e["action"] for e in events
                                    if e["event"] == "autoscale_decision"))
    # the control loop's ticks, seconds from the load's start
    rec["timeline"] = [(round(e["t"] - t0, 1), e.get("action", e["event"]), e.get("reason"),
                        e.get("fleet_p99_ms"), e.get("burn_fast"), e.get("offered_rps"),
                        e.get("running")) for e in events]
    rec["replicas"] = {}
    for name in sorted(pids):
        with open(os.path.join(rdir, f"{name}.log")) as f:
            lines = [ln for ln in f if ln.startswith("{")]
        drained = next(json.loads(ln) for ln in reversed(lines) if '"drained"' in ln)
        first_line = next(json.loads(ln) for ln in lines if '"listening"' in ln)
        rec["replicas"][name] = {"launches": drained["launches"], "start_s": first_line["start_s"]}
        if dev.type == "cuda":
            got = drained["launches"]
            assert got["sift_bin_sample"] > 0 and got["plane_sandwich"] > 0, (name, got)
    assert len(pids) == 2, (pids, rec["timeline"])
    log(f"17d serve-autoscale: {rec} on {smi}")
    return rec


def capacity_plan(dev, smi, root):
    """Phase 17e: ``serve-capacity-plan --mode inproc`` over the demo model
    on the card, replicas 1,2 x speeds 1,2, at 17d's objective: the
    artifact's fitted per-replica rate, which ``PolicyConfig.from_plan``
    loads. The planner's output, every cell included, goes to
    ``plan.log``."""
    from keystone_tpu_torch.autoscale import PolicyConfig
    from keystone_tpu_torch.autoscale import planner

    path = os.path.join(root, "plan.json")
    out = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = planner.main(P17_PLAN + ["--out", path], device=dev)
    finally:
        with open(os.path.join(root, "plan.log"), "w") as f:
            f.write(out.getvalue())
    rec = {"s": time.perf_counter() - t, "rc": rc}
    artifact = json.load(open(path))
    rec["fit"] = artifact["fit"]
    rec["capacity_rps_by_replicas"] = artifact["capacity_rps_by_replicas"]
    rec["rows"] = [{k: r[k] for k in ("replicas", "speed", "offered_rps", "p99_ms", "shed_rate",
                                      "lost", "errors", "slo_held")}
                   for r in artifact["rows"]]
    assert rc == 0 and artifact["fit"]["per_replica_rps"] is not None, rec
    rec["policy"] = dataclasses.asdict(PolicyConfig.from_plan(path))
    log(f"17e serve-capacity-plan: {rec} on {smi}")
    return rec


def cold_start_sharding_elasticity(dev, smi, feat, model, img=IMG, autoscale=None):
    """Phase 17: 17a/b (``aot_round_trip``), 17c (``sharded_gateway``),
    17d (``autoscale_drill``) and 17e (``capacity_plan``). ``autoscale``
    overrides 17d's sizes. To rehearse it on the CPU at a small size, with
    a 48² chain and head (``phase4_chain(torch.device("cpu"), 48)``):
    ``cold_start_sharding_elasticity(torch.device("cpu"), "cpu", feat,
    model, img=48, autoscale=dict(rate_high=150, high_s=20, rate_low=2,
    low_s=30))``."""
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "tmp", "phase17")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rec = {"card": smi}
    try:
        t = time.perf_counter()
        rec["aot"], gateway_dir = aot_round_trip(dev, smi, feat, model, root, img=img)
        rec["aot"]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rec["sharding"] = sharded_gateway(dev, smi, feat, model, root, gateway_dir,
                                          rec["aot"]["gateway_answers"], img=img)
        rec["sharding"]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rec["autoscale"] = autoscale_drill(dev, smi, root, gateway_dir, img=img,
                                           **(autoscale or {}))
        rec["autoscale"]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rec["plan"] = capacity_plan(dev, smi, root)
        rec["plan"]["phase_s"] = time.perf_counter() - t
    finally:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        for name in ("servers.log", "autoscale.log", "loadgen.log", "plan.log"):
            with contextlib.suppress(OSError):
                shutil.copy(os.path.join(root, name),
                            os.path.join(ROOT, "chiprun_out", f"phase17_{name}"))
        with contextlib.suppress(OSError):
            shutil.copytree(os.path.join(root, "replicas"),
                            os.path.join(ROOT, "chiprun_out", "phase17_replicas"),
                            dirs_exist_ok=True)
        shutil.rmtree(root, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17 in {rec['phase_s']:.3f} s on {smi}")
    return rec


# phase 18: the bench rows' names of phase 3's kernels
BENCH_TAGS = {"sift_bin_sample": "B1", "plane_sandwich": "B2", "fisher_vector_stats": "B3"}


def _port_tool(args, timeout=120):
    """``python -m keystone_tpu_torch <args>`` from the checkout, as a
    user runs it: (exit code, stdout)."""
    out = subprocess.run([sys.executable, "-m", "keystone_tpu_torch", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    if out.stderr:
        log(out.stderr.strip())
    return out.returncode, out.stdout


def lint_and_bench_diff(smi, rows):
    """Phase 18, host only: the port's keystone-lint over the checkout
    (exit 0, clean), then ``bench-diff`` over ``rows`` (phase 3's kernel
    rows) written as bench rows to a temporary directory: against
    themselves (exit 0), and against a copy with B1's time doubled (exit
    1, B1 the only regression). To rehearse it on the CPU:
    ``lint_and_bench_diff("cpu", [{"name": "sift_bin_sample", "ms": 0.7},
    {"name": "plane_sandwich", "ms": 0.1}, {"name": "fisher_vector_stats",
    "ms": 0.7}])``."""
    import tempfile

    t_phase = time.perf_counter()
    rec = {"card": smi}
    t = time.perf_counter()
    rc, out = _port_tool(["keystone-lint", "--json"])
    doc = json.loads(out)
    rec["lint"] = {"rc": rc, "clean": doc["clean"], "files": doc["files"],
                   "counts": doc["counts"], "s": time.perf_counter() - t}
    assert rc == 0 and doc["clean"], (rec, doc["findings"], doc["stale_baseline"])
    bench = [{"metric": f"{BENCH_TAGS[r['name']]}_ms", "value": r["ms"], "unit": "ms"}
             for r in rows]
    slower = [dict(b, value=2 * b["value"]) if b["metric"] == "B1_ms" else b for b in bench]
    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for name, doc_rows in (("this_run", bench), ("b1_doubled", slower)):
            paths[name] = os.path.join(d, f"{name}.jsonl")
            with open(paths[name], "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in doc_rows)
        t = time.perf_counter()
        rc_same, _ = _port_tool(["bench-diff", paths["this_run"], paths["this_run"]])
        rc_slow, out = _port_tool(["bench-diff", paths["this_run"], paths["b1_doubled"], "--json"])
        report = json.loads(out)
    rec["bench_diff"] = {"rows": bench, "rc_same": rc_same, "rc_b1_doubled": rc_slow,
                         "regressions": report["regressions"], "s": time.perf_counter() - t}
    assert rc_same == 0 and rc_slow == 1 and report["regressions"] == ["B1_ms"], rec
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"18 keystone-lint: {rec['lint']}; bench-diff: {rec['bench_diff']} on {smi}")
    log(f"phase 18 in {rec['phase_s']:.3f} s on {smi}")
    return rec


def _info(info):
    return None if info is None else {k: float(v) for k, v in info.items()}


# phase 19: python -m keystone_tpu_torch serve-bench in fresh processes, at
# the JAX defaults (the demo chain at d 256, hidden 512, depth 4, buckets
# 8, 32, 128; the featurize rows at their own shapes), the rows each run
# must print, in order. The default run leaves out the cold-start row
# (ROADMAP C8) and the overlap row (C9), whose floors the card misses.
P19_RUNS = (
    ("default", ["--no-cold-start", "--no-pipeline-overlap"],
     ("serving_cold_vs_warm_latency", "serving_bucketed_throughput", "serving_microbatch_p99",
      "serving_gateway_p99", "serving_swap_blip", "serving_goodput_mfu")),
    ("featurize", ["--featurize-only"],
     ("serving_device_featurize", "serving_flagship_featurize")),
)
P19_TIMEOUT_S = 300
# the overlap row's fixed prep wait (bench_pipeline_overlap's prep_latency_ms)
P19_PREP_WAIT_MS = 10.0


def serve_bench(smi):
    """Phase 19: ``serve-bench --no-cold-start --no-pipeline-overlap``
    (the default rows but the overlap row) and ``--featurize-only`` (the
    two featurize rows), each once in a fresh process with an AOT store
    under the gitignored ``tmp/phase19_aot``. Each must exit 0 (so every
    in-row check held) having printed its rows in order; the goodput row
    must have a cost model and an MFU, the flagship row an MFU and a
    roofline class for every bucket, and the featurize process's
    ``kernel_launches`` line B1, B2 and B3 each at least once. On the card
    only (the children run on ``cuda``; the rows' CPU tests are
    ``tests/test_torch_serve_bench.py``)."""
    t_phase = time.perf_counter()
    aot = os.path.join(ROOT, "tmp", "phase19_aot")
    shutil.rmtree(aot, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    rec = {}
    try:
        for name, flags, want in P19_RUNS:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "keystone_tpu_torch", "serve-bench", *flags, "--aot-cache", aot],
                capture_output=True, text=True, timeout=P19_TIMEOUT_S, cwd=ROOT,
            )
            with open(os.path.join(ROOT, "chiprun_out", f"phase19_{name}.log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
            lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
            rows = {r["metric"]: r for r in lines if "metric" in r}
            launches = next((r["kernel_launches"] for r in lines if "kernel_launches" in r), None)
            for r in rows.values():
                log(f"19 {name}: {json.dumps(r)}")
                if "speedup_vs_host" in r:
                    log(f"19 {r['metric']}: host path (jit_batch) {r['host_examples_per_sec']} ex/s, "
                        f"device {r['device_examples_per_sec']} ex/s, speedup_vs_host "
                        f"{r['speedup_vs_host']} on {smi}")
            rec[name] = {"rc": proc.returncode, "s": time.perf_counter() - t0, "rows": rows,
                         "launches": launches}
            log(f"19 {name}: exit {proc.returncode} in {rec[name]['s']:.3f} s, kernel launches "
                f"{launches} on {smi}")
            assert proc.returncode == 0, proc.stderr[-4000:]
            assert tuple(rows) == want, (tuple(rows), want)
    finally:
        shutil.rmtree(aot, ignore_errors=True)
    goodput = rec["default"]["rows"]["serving_goodput_mfu"]
    assert goodput["cost_analysis_available"] is True and goodput["mfu"] is not None, goodput
    flagship = rec["featurize"]["rows"]["serving_flagship_featurize"]
    assert flagship["mfu"] is not None, flagship
    assert all(v is not None for v in flagship["roofline"].values()), flagship["roofline"]
    assert all(rec["featurize"]["launches"][k] > 0 for k in _cuda.LAUNCHES), rec["featurize"]
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19 in {rec['phase_s']:.3f} s on {smi}")
    return rec


class _HostNode(api.Transformer):
    """A node that maps each example on the host (items mode): work one
    captured program cannot hold."""

    def apply(self, x):
        return x * 2.0

    def apply_batch(self, ds):
        return ds.map(self.apply)


# phase 20: jit_batch calls at these row counts (captures 1, 1, 0)
P20_CALLS = (64, 37, 64)


def jit_batch_phase(dev, smi, feat, model, img=IMG):
    """Phase 20: ``feat.jit_batch()`` on phase 4's chain at 64, 37 and 64
    rows of 256² uint8 images (numpy in, as the bench rows' host path),
    held against the engine's bucket-64 featurize graph (bit for bit) and
    eager ``_batch_run`` (the serving bar); ``jit()`` on one image; the
    replay at 64 timed beside the engine's and beside eager; an
    items-mode chain must raise."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(20)
    raw = rng.integers(0, 256, (max(P20_CALLS), img, img, 3), dtype=np.uint8)
    x = torch.as_tensor(raw).to(dev)
    f = feat.jit_batch(device=dev)
    rec = {"calls": []}
    outs = []
    for rows in P20_CALLS:
        before = f.captures
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = f(raw[:rows])
        torch.cuda.synchronize()
        call = {"rows": rows, "s": time.perf_counter() - t0,
                "captures": f.captures - before, "launches": dict(_cuda.LAUNCHES)}
        rec["calls"].append(call)
        outs.append(out)
        assert tuple(out.shape) == (rows, 8192) and bool(torch.isfinite(out).all()), out.shape
    rec["graphs"] = [dict(g, spec=str(g["spec"])) for g in f.graph_report()]
    log(f"20 jit_batch calls (rows, captures, seconds, launches): "
        f"{[(c['rows'], c['captures'], round(c['s'], 3), c['launches']) for c in rec['calls']]}; "
        f"captures (s, pool bytes): {[(g['capture_s'], g['pool_bytes']) for g in rec['graphs']]} on {smi}")
    assert [c["captures"] for c in rec["calls"]] == [1, 1, 0], rec["calls"]
    per_call = {"sift_bin_sample": 4, "plane_sandwich": 1, "fisher_vector_stats": 2}
    # a capture's launches are its tally; a call that captures nothing
    # launches exactly one replay's
    assert all(g["launches"] == per_call for g in rec["graphs"]), rec["graphs"]
    assert rec["calls"][2]["launches"] == per_call, rec["calls"][2]
    rec["launches_per_call"] = dict(rec["calls"][2]["launches"])
    out64, out37, again = outs
    assert torch.equal(again, out64)

    with torch.no_grad():
        eager = feat._batch_run(x)
    eng = feat.compiled((64,), device=dev)
    eng.warmup(example=np.zeros((img, img, 3), np.uint8))
    rec["engine_graphs"] = eng.graph_report()
    engine_out = eng.apply(x, sync=True)
    head = model.compiled((64,), featurize=feat, device=dev)
    head.warmup(example=np.zeros((img, img, 3), np.uint8))
    top_engine = head.apply(x, sync=True)
    with torch.no_grad():
        top_jit = model._batch_run(out64)
    rec["max_abs_vs_engine"] = float((out64 - engine_out).abs().max())
    rec["bit_for_bit_vs_engine"] = bool(torch.equal(out64, engine_out))
    rec["max_abs_vs_eager"] = max_abs_err(out64, eager, RTOL_FEAT, ATOL_FEAT, "20 jit_batch vs eager")
    rec["max_abs_37_vs_64"] = max_abs_err(out37, out64[:37], RTOL_FEAT, ATOL_FEAT,
                                          "20 jit_batch at 37 rows vs the first 37 at 64")
    rec["top5_equal"] = bool(torch.equal(top_jit, top_engine))
    log(f"20 the engine's bucket-64 featurize graph: {rec['engine_graphs']}")
    log(f"20 outputs at 64: vs the engine's bucket-64 graph bit for bit {rec['bit_for_bit_vs_engine']} "
        f"(max abs {rec['max_abs_vs_engine']}), vs eager max abs {rec['max_abs_vs_eager']}; 37 rows vs "
        f"the first 37 at 64 max abs {rec['max_abs_37_vs_64']}; top-5 equal {rec['top5_equal']}")
    assert rec["bit_for_bit_vs_engine"], rec["max_abs_vs_engine"]
    assert rec["top5_equal"]

    one = feat.jit(device=dev)
    single = one(raw[0])
    torch.cuda.synchronize()
    rec["jit_graphs"] = [dict(g, spec=str(g["spec"])) for g in one.graph_report()]
    assert one.captures == 1 and tuple(single.shape) == (8192,), rec["jit_graphs"]
    rec["jit_max_abs_vs_batch"] = max_abs_err(single, out64[0], RTOL_FEAT, ATOL_FEAT,
                                              "20 jit() of one image vs its row at 64")
    log(f"20 jit() of one image: capture {rec['jit_graphs']}, max abs vs its row at 64 "
        f"{rec['jit_max_abs_vs_batch']}")

    rec["replay_ms"] = time_ms(lambda: f(x))
    rec["engine_replay_ms"] = time_ms(lambda: eng.apply(x))
    with torch.no_grad():
        rec["eager_ms"] = time_ms(lambda: feat._batch_run(x))
    log(f"20 a call at 64 by CUDA events: jit_batch {rec['replay_ms']:.3f} ms, the engine's bucket-64 "
        f"{rec['engine_replay_ms']:.3f} ms, eager _batch_run {rec['eager_ms']:.3f} ms on {smi}")

    hosted = _HostNode().to_pipeline().fit()
    try:
        hosted.jit_batch(device=dev)(torch.ones((3, 2), device=dev))
    except TypeError as e:
        rec["items_mode_raises"] = str(e)
    assert "use apply" in rec.get("items_mode_raises", ""), rec
    log(f"20 an items-mode chain raises on the card: {rec['items_mode_raises']}")
    eng.release_graphs()
    head.release_graphs()
    del f, one, eng, head
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20 in {rec['phase_s']:.3f} s on {smi}")
    return rec


def _thread_cpu_s(thread):
    """CPU seconds a live thread has run (its own clock)."""
    return time.clock_gettime(time.pthread_getcpuclockid(thread.ident))


@contextlib.contextmanager
def lane_split(by_lane=False):
    """How a lane's host time splits, by thread, for every ``MicroBatcher``
    made inside the block: one record per mode, ``serial`` or
    ``pipelined``, summed over its batchers, or with ``by_lane`` one per
    lane, named as its engine (a gateway's lanes are ``<gateway>-lane<i>``).
    Per window: the wall and CPU milliseconds of the prep's assembly
    (``_assemble``: the host featurize, its fixed wait included), of the
    serial dispatch (``_dispatch``, the assembly inside it) and of each
    pipelined stage, and inside the deliver stage of its copy to the host
    (``d2h``) and of the requests' completion callbacks (``callbacks``:
    under a gateway, the pool's and the admission's chain);
    ``*_gil_wait_ms`` is wall less CPU less the featurize's fixed wait, the
    time the step sat off the CPU waiting (for the interpreter lock, a
    queue or the card). Over the batcher's life: each thread's CPU seconds
    (the client is the thread that made and closed the batcher;
    ``coalesce`` its dispatcher; the four stage threads) against the wall
    seconds, and the cyclic garbage collector's pauses of generations 1
    and 2 while the batcher lived (``gc_ms``: every thread stops for them).

    Under a ``Gateway`` the block also records, in ``split["passes"]``,
    every client pass of the bench rows (``bench._clients``): its
    gateway, requests, wall seconds and requests/s, the lane's windows in
    it, the CPU milliseconds per window of each of the gateway's threads
    (the client threads, the admission router, the coalesce thread and
    the four stage threads), and every collection of the cyclic collector
    inside it (generation, milliseconds, the objects it collected, as
    ``gc.callbacks`` reports them). Only the wrappers it puts on the
    classes cost anything: two clock reads a step, a window's callbacks
    and a client's request."""
    import gc

    from keystone_tpu_torch.gateway import admission
    from keystone_tpu_torch.serving import batching, bench, pipeline

    split = {}
    steps = {}
    patched = []
    current = [None]
    collections = []  # (start, generation, ms, collected, uncollectable)
    gc_started = [0.0]
    admissions = {}  # gateway name -> AdmissionController
    tls = threading.local()

    def acc(key, label, wall, cpu):
        rec = steps.setdefault(key, {}).setdefault(label, [0.0, 0.0, 0, 0.0])
        rec[0] += wall
        rec[1] += cpu
        rec[2] += 1
        rec[3] = max(rec[3], wall)

    def on_gc(phase, info):
        now = time.perf_counter()
        if phase == "start":
            gc_started[0] = now
            return
        ms = (now - gc_started[0]) * 1e3
        collections.append((gc_started[0], info["generation"], ms, info["collected"],
                            info["uncollectable"]))
        if not by_lane and current[0] is not None and info["generation"] >= 1:
            split.setdefault(current[0], {"wall_s": 0.0, "cpu_s": {}}).setdefault("gc_ms", []).append(
                (info["generation"], round(ms, 1)))

    def timed(owner, name, label, key_of):
        orig = getattr(owner, name)

        def wrapper(self, *a, **k):
            outer = getattr(tls, "key", None)
            tls.key = key = key_of(self) if key_of is not None else outer
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return orig(self, *a, **k)
            finally:
                if key is not None:
                    acc(key, label, time.perf_counter() - w0, time.thread_time() - c0)
                tls.key = outer

        patched.append((owner, name, orig))
        setattr(owner, name, wrapper)

    def batcher_key(mb):
        if by_lane:
            return mb.engine.name
        return "pipelined" if mb.pipeline_depth else "serial"

    def pipeline_key(pipe):
        return pipe.name if by_lane else "pipelined"

    for stage in pipeline.LanePipeline.STAGES:
        timed(pipeline.LanePipeline, f"_{stage}", stage, pipeline_key)
    timed(batching.MicroBatcher, "_assemble", "assemble", batcher_key)
    timed(batching.MicroBatcher, "_dispatch", "dispatch", batcher_key)
    # inside a window's delivery (its key is the stage's, on this thread)
    to_numpy = pipeline._to_numpy

    def d2h(a):
        w0, c0 = time.perf_counter(), time.thread_time()
        try:
            return to_numpy(a)
        finally:
            if getattr(tls, "key", None) is not None:
                acc(tls.key, "d2h", time.perf_counter() - w0, time.thread_time() - c0)

    patched.append((pipeline, "_to_numpy", to_numpy))
    pipeline._to_numpy = d2h
    # a request's callbacks, counted once: the outermost future's (the
    # lane's), whose callbacks settle the pool's and the caller's
    invoke = pipeline.LaneFuture._invoke_callbacks

    def callbacks(fut):
        if getattr(tls, "in_callbacks", False) or getattr(tls, "key", None) is None:
            return invoke(fut)
        tls.in_callbacks = True
        w0, c0 = time.perf_counter(), time.thread_time()
        try:
            return invoke(fut)
        finally:
            tls.in_callbacks = False
            acc(tls.key, "callbacks", time.perf_counter() - w0, time.thread_time() - c0)

    patched.append((pipeline.LaneFuture, "_invoke_callbacks", invoke))
    pipeline.LaneFuture._invoke_callbacks = callbacks
    # each window: its first request's enqueue to its take (the batching
    # wait, a full window's or the deadline's), and the previous window's
    # first enqueue to this one's (the window's cycle, the whole trip
    # through the plane and back to the clients)
    started = {}
    take_batch = batching.MicroBatcher._take_batch

    def take_wrapper(self):
        batch, engine = take_batch(self)
        if batch:
            key, first = batcher_key(self), batch[0][2]
            acc(key, "batching_wait", time.perf_counter() - first, 0.0)
            if key in started:
                acc(key, "cycle", first - started[key], 0.0)
            started[key] = first
        return batch, engine

    patched.append((batching.MicroBatcher, "_take_batch", take_batch))
    batching.MicroBatcher._take_batch = take_wrapper
    init, close = batching.MicroBatcher.__init__, batching.MicroBatcher.close

    def init_wrapper(self, *a, **k):
        init(self, *a, **k)
        current[0] = batcher_key(self)
        self._split_start = (time.perf_counter(), time.thread_time())

    def close_wrapper(self, *a, **k):
        wall0, client0 = self._split_start
        cpu = {name: _thread_cpu_s(t) for name, t in _lane_threads(self).items() if t.is_alive()}
        cpu["client"] = time.thread_time() - client0
        rec = split.setdefault(batcher_key(self), {"wall_s": 0.0, "cpu_s": {}})
        rec["wall_s"] += time.perf_counter() - wall0
        for name, s in cpu.items():
            rec["cpu_s"][name] = rec["cpu_s"].get(name, 0.0) + s
        try:
            return close(self, *a, **k)
        finally:
            current[0] = None

    patched += [(batching.MicroBatcher, "__init__", init), (batching.MicroBatcher, "close", close)]
    batching.MicroBatcher.__init__ = init_wrapper
    batching.MicroBatcher.close = close_wrapper

    admission_init = admission.AdmissionController.__init__

    def admission_wrapper(self, *a, **k):
        admission_init(self, *a, **k)
        admissions[self.name] = self

    patched.append((admission.AdmissionController, "__init__", admission_init))
    admission.AdmissionController.__init__ = admission_wrapper
    clients = bench._clients

    def clients_wrapper(submit, inputs, n_threads, what):
        ctrl = admissions.get(what)
        if ctrl is None:
            return clients(submit, inputs, n_threads, what)
        lanes = [lane.batcher for lane in ctrl.pool.lanes]
        threads = {"router": ctrl._router}
        for mb in lanes:
            threads.update(_lane_threads(mb))
        client_cpu = [0.0]
        lock = threading.Lock()

        def timed_submit(x):
            c0 = time.thread_time()
            try:
                return submit(x)
            finally:
                with lock:
                    client_cpu[0] += time.thread_time() - c0

        def windows():
            return sum(steps.get(batcher_key(mb), {}).get("dispatch", [0, 0, 0])[2] for mb in lanes)

        cpu0 = {name: _thread_cpu_s(t) for name, t in threads.items()}
        keys = [batcher_key(mb) for mb in lanes]
        for key in keys:
            started.pop(key, None)  # a pass's first window has no cycle
        steps0 = {(key, label): rec[0] for key in keys for label, rec in steps.get(key, {}).items()}
        n0, k0 = windows(), len(collections)
        t0 = time.perf_counter()
        try:
            return clients(timed_submit, inputs, n_threads, what)
        finally:
            wall = time.perf_counter() - t0
            n = max(windows() - n0, 1)
            cpu = {name: (_thread_cpu_s(t) - cpu0[name]) / n * 1e3 for name, t in threads.items()}
            cpu["clients"] = client_cpu[0] / n * 1e3
            gcs = [c for c in collections[k0:] if c[0] >= t0]
            steps_ms = {}
            for key in keys:
                for label, rec in steps.get(key, {}).items():
                    steps_ms[label] = steps_ms.get(label, 0.0) + rec[0] - steps0.get((key, label), 0.0)
            split.setdefault("passes", []).append({
                "gateway": what, "requests": len(inputs), "s": round(wall, 4),
                "rate": round(len(inputs) / wall, 1), "windows": n,
                "steps_ms_per_window": {k: round(v / n * 1e3, 3) for k, v in steps_ms.items()},
                "cpu_ms_per_window": {k: round(v, 3) for k, v in cpu.items()},
                "gc": [(g, round(ms, 2), collected, uncollectable)
                       for _, g, ms, collected, uncollectable in gcs if g >= 1],
                "gc0": [sum(1 for c in gcs if c[1] == 0), round(sum(c[2] for c in gcs if c[1] == 0), 2)],
            })

    patched.append((bench, "_clients", clients))
    bench._clients = clients_wrapper
    gc.callbacks.append(on_gc)
    try:
        yield split
    finally:
        gc.callbacks.remove(on_gc)
        for owner, name, orig in reversed(patched):
            setattr(owner, name, orig)
        for key, labels in steps.items():
            rec = split.setdefault(key, {"wall_s": 0.0, "cpu_s": {}})
            windows = labels["assemble"][2] if "assemble" in labels else labels["dispatch"][2]
            rec["windows"] = windows
            for label, (wall, cpu, n, most) in labels.items():
                rec[f"{label}_ms"] = round(wall / windows * 1e3, 3)
                rec[f"{label}_cpu_ms"] = round(cpu / windows * 1e3, 3)
                rec[f"{label}_max_ms"] = round(most * 1e3, 3)
            rec["wall_s"] = round(rec["wall_s"], 4)
            rec["cpu_s"] = {k: round(v, 4) for k, v in rec["cpu_s"].items()}


def _lane_threads(mb):
    """A batcher's threads by role: its coalesce thread and, pipelined,
    its four stage threads."""
    threads = {"coalesce": mb._worker}
    if mb._pipeline is not None:
        threads.update(zip(type(mb._pipeline).STAGES, mb._pipeline._threads))
    return threads


class _ListeningTee:
    """A child's stdout that keeps the ``{"listening": ...}`` line it
    passes on (``cold_start_runs``)."""

    def __init__(self, stream, into):
        self._stream, self._into = stream, into

    def __iter__(self):
        return self

    def __next__(self):
        line = next(self._stream)
        if line.startswith('{"listening"'):
            self._into.append(json.loads(line))
        return line

    def __getattr__(self, name):
        return getattr(self._stream, name)


def cold_start_runs(n, device=None, **row):
    """``python3 chip_smoke.py --cold-start-runs N``: the
    ``serving_cold_start_aot`` row, as ``serve-bench`` runs it (a fresh
    ``serve-gateway`` of the depth-40 demo chain, 4 lanes, 6 buckets, cold
    and from the AOT store, exec to first ``/predict``), N times, each in
    the fresh processes the row starts; prints each run's row or the check
    it failed, with each child's start split (its listening line's
    ``start_s``: import up to ``main``, CUDA context, model, the
    Gateway's lanes and warmup), then the count that passed. Not a phase:
    the row's pass rate on the card (ROADMAP C8). On the CPU, at a small
    size: ``cold_start_runs(1, "cpu", depth=2, buckets=(4,), lanes=1)``
    (about 30 s; the row's 3.0x floor is for the card)."""
    from keystone_tpu_torch.serving import bench

    smi = "cpu" if device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    passed = 0
    popen = subprocess.Popen
    for i in range(n):
        rows, starts = [], []

        class Teeing(popen):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                if self.stdout is not None and "serve-gateway" in a[0]:
                    self.stdout = _ListeningTee(self.stdout, starts)

        subprocess.Popen = Teeing
        try:
            bench.bench_cold_start_aot(lambda *a, **k: rows.append((a, k.get("extra"))),
                                       device=device, **row)
            passed += 1
            outcome = f"passed {json.dumps({'ms_to_first_predict': rows[0][0][1], **rows[0][1]})}"
        except RuntimeError as e:
            outcome = f"failed: {e}"
        finally:
            subprocess.Popen = popen
        log(f"cold start run {i + 1}: {outcome}")
        for name, doc in zip(("cold", "from the store"), starts):
            log(f"cold start run {i + 1} {name} start split: {json.dumps(doc['start_s'])} on {smi}")
    log(json.dumps({"cold_start_runs": n, "passed": passed, "card": smi}))
    return passed


def overlap_runs(n, dev=None, fitted=None, window_rows=(8, 32, 128), d=256):
    """``python3 chip_smoke.py --overlap-runs N``: the
    ``serving_pipeline_overlap`` row, as ``serve-bench`` runs it (the demo
    chain at the JAX defaults, on the card), N times in this process;
    prints each run's row or the check it failed with the lane's host
    split (``lane_split``: the fixed wait of the prep is
    ``P19_PREP_WAIT_MS``), then the count that passed. Not a phase: the
    row's pass rate on the card (ROADMAP C9). On the CPU:
    ``overlap_runs(2, "cpu", bench.build_pipeline(256, 32, 1,
    device="cpu"))`` (about 10 s)."""
    from keystone_tpu_torch.serving import bench

    smi = "cpu" if dev == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    fitted = fitted or bench.build_pipeline(256, 512, 4)
    passed, at_least_serial = 0, 0
    for i in range(n):
        rows = []
        with lane_split() as split:
            try:
                bench.bench_pipeline_overlap(lambda *a, **k: rows.append(k.get("extra")), fitted,
                                             window_rows, d, device=dev)
                passed += 1
                outcome = f"passed {json.dumps(rows[0])}"
            except RuntimeError as e:
                outcome = f"failed: {e}"
        speedup = re.search(r"only ([0-9.]+)x the serial", outcome)
        speedup = float(speedup.group(1)) if speedup else rows[0]["speedup_vs_serial"] if rows else None
        at_least_serial += speedup is not None and speedup >= 1.0
        for mode in ("serial", "pipelined"):
            s = split.get(mode, {})
            s["assemble_gil_wait_ms"] = round(s.get("assemble_ms", 0.0) - s.get("assemble_cpu_ms", 0.0)
                                              - P19_PREP_WAIT_MS, 3)
        log(f"overlap run {i + 1}: {outcome}")
        log(f"overlap run {i + 1} host split: {json.dumps(split)} on {smi}")
    log(json.dumps({"overlap_runs": n, "passed": passed, "at_least_serial": at_least_serial,
                    "card": smi}))
    return passed, at_least_serial


def featurize_runs(n, dev=None):
    """``python3 chip_smoke.py --featurize-runs N``: the
    ``serving_device_featurize`` row, as ``serve-bench`` runs it (JAX's
    defaults; the host path through ``jit_batch``), N times in this
    process; prints each run's row or the check it failed, then the
    count that passed. Not a phase: the row's pass rate on the card
    (ROADMAP C11). On the CPU ``featurize_runs(1, "cpu")`` runs in about
    2 s; the row's checks are set for the card."""
    from keystone_tpu_torch.serving import bench

    smi = "cpu" if dev == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    passed = 0
    for i in range(n):
        rows = []
        try:
            bench.bench_device_featurize(lambda *a, **k: rows.append(k.get("extra")), device=dev)
            passed += 1
            outcome = f"passed {json.dumps(rows[0])}"
        except RuntimeError as e:
            outcome = f"failed: {e}"
        log(f"featurize run {i + 1}: {outcome} on {smi}")
    log(json.dumps({"featurize_runs": n, "passed": passed, "card": smi}))
    return passed


# seconds a fresh ``--featurize-process`` child may take (its import,
# the first child's kernel build and both featurize rows)
FEATURIZE_PROCESS_TIMEOUT_S = 600


def featurize_process(aot):
    """``python3 chip_smoke.py --featurize-process AOT``: one fresh process
    of ``serve-bench --featurize-only --aot-cache AOT`` (phase 19's
    featurize process: both featurize rows) inside ``lane_split`` by lane;
    prints the rows, the launch line and then the split as one JSON line
    ``{"lane_split": ...}``, and exits as the rows did (1 if a check
    raised)."""
    from keystone_tpu_torch import __main__ as cli

    rc = 1
    with lane_split(by_lane=True) as split:
        try:
            rc = cli.main(["serve-bench", "--featurize-only", "--aot-cache", aot])
        except RuntimeError as e:
            print(f"featurize process: {e!r}", file=sys.stderr, flush=True)
    print(json.dumps({"lane_split": split}), flush=True)
    sys.exit(rc)


def _lane_summary(split, gateway):
    """One gateway's line of a ``--featurize-process`` split: its measured
    passes (the row's 384-request ones)."""
    passes = [p for p in split.get("passes", []) if p["gateway"] == gateway and p["requests"] >= 384]
    return {
        "rates": [p["rate"] for p in passes],
        "window_rows": [round(p["requests"] / p["windows"], 2) for p in passes],
        "steps_ms_per_window": [p["steps_ms_per_window"] for p in passes],
        "cpu_ms_per_window": [p["cpu_ms_per_window"] for p in passes],
        "gc": [p["gc"] for p in passes],
        "gc0": [p["gc0"] for p in passes],
    }


def featurize_processes(n):
    """``python3 chip_smoke.py --featurize-processes N``: phase 19's
    featurize process (``serve-bench --featurize-only``, both featurize
    rows at JAX's defaults, one AOT store) N times, each in a fresh
    ``--featurize-process`` child that records the gateway split
    (``lane_split(by_lane=True)``); prints each run's exit code, both
    rows' host and device ex/s and ``speedup_vs_host``, and for each lane
    of the ``serving_device_featurize`` row its measured passes (req/s,
    rows a window, each step's ms a window: the batching wait, prep,
    upload, compute, deliver with its copy to the host and the requests'
    callbacks, the window's cycle; each thread's CPU ms a window;
    the collector's gen-1/2 pauses with the objects they collected,
    gen-0's count and ms); then the count that exited 0 and the spread. Each child's whole output goes to
    ``chiprun_out/featurize_processes/``. Not a phase: the rows' pass rate
    on the card in fresh processes (ROADMAP C11). On the card only (the
    children run on ``cuda``); the split rehearses on the CPU inside
    ``lane_split(by_lane=True)`` around ``bench.bench_device_featurize(...,
    device="cpu")``."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    aot = os.path.join(ROOT, "tmp", "featurize_processes_aot")
    out = os.path.join(ROOT, "chiprun_out", "featurize_processes")
    shutil.rmtree(aot, ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    runs = []
    try:
        for i in range(n):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--featurize-process", aot],
                                  capture_output=True, text=True, timeout=FEATURIZE_PROCESS_TIMEOUT_S,
                                  cwd=ROOT)
            with open(os.path.join(out, f"run{i + 1}.log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
            lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
            rows = {r["metric"]: r for r in lines if "metric" in r}
            split = next((r["lane_split"] for r in lines if "lane_split" in r), {})
            run = {"rc": proc.returncode, "s": round(time.perf_counter() - t0, 1)}
            for metric, row in rows.items():
                run[metric] = [row["host_examples_per_sec"], row["device_examples_per_sec"],
                               row["speedup_vs_host"]]
            if proc.returncode:
                run["error"] = proc.stderr.strip().splitlines()[-1:] or ["(no stderr)"]
            runs.append(run)
            log(f"featurize process {i + 1}: {json.dumps(run)} on {smi}")
            for side in ("host", "device"):
                log(f"featurize process {i + 1} {side} lane: "
                    f"{json.dumps(_lane_summary(split, f'bench-feat-{side}'))}")
    finally:
        shutil.rmtree(aot, ignore_errors=True)
    passed = sum(r["rc"] == 0 for r in runs)
    speedups = [r["serving_device_featurize"][2] for r in runs if "serving_device_featurize" in r]
    log(json.dumps({"featurize_processes": n, "passed": passed,
                    "device_row_speedup": [min(speedups, default=None), max(speedups, default=None)],
                    "card": smi}))
    return passed


def autoscale_runs(n, linger_s=15.0):
    """``python3 chip_smoke.py --autoscale-runs N``: phase 17d's drill N
    times over one AOT store (17b's, built here), the autoscaler kept
    ``linger_s`` past each retire; prints each run's outcome and its
    autoscaler timeline (seconds from the load's start, action, reason,
    fleet p99 ms, fast burn, offered req/s, replicas running), then the
    count with two replica starts. Not a phase: the drill's flap rate."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    _cuda.build()
    root = os.path.join(ROOT, "tmp", "autoscale_runs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    feat, model = phase4_chain(dev)
    _, gateway_dir = aot_round_trip(dev, smi, feat, model, root)
    del feat, model
    torch.cuda.empty_cache()
    two = 0
    try:
        for i in range(n):
            shutil.rmtree(os.path.join(root, "replicas"), ignore_errors=True)
            try:
                rec = autoscale_drill(dev, smi, root, gateway_dir, linger_s=linger_s)
                two += 1
                outcome, timeline = "two starts", rec["timeline"]
            except AssertionError as e:
                outcome, timeline = f"failed: {e.args[0] if e.args else e}", None
            log(f"autoscale run {i + 1}: {outcome}")
            for row in timeline or ():
                log(f"autoscale run {i + 1} tick: {json.dumps(row)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(json.dumps({"autoscale_runs": n, "two_starts": two, "card": smi}))
    return two


# phase 21: the data-parallel layer at TIMIT's published widths (the JAX
# package's timit.py defaults: 40 x 4,096 cosines of 440 dimensions,
# 147 classes, blocks of 4,096) on phase 11d's 32,768 training frames;
# the host-block fit on as many rows (21.5 GB of host RAM at one
# process); qr_q at phase 13's shape; device_shuffle of phase 13's rows
P21_ROWS = P11_TIMIT[0]
P21_COSINES, P21_EPOCHS, P21_HOST_EPOCHS = 40, 2, 1
P21_HOST_ROWS = P11_TIMIT[0]
P21_MIN_TRAIN_ACC = 0.9
P21_TIMEOUT_S = 600
FIT_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_block_ls.py:29
# 21 (a): the flagship's weighted fit on sharded rows at phase 6's widths
# (2,000 seeded 256² images, 1,000 classes, 8,192 features, the solver's
# block 4,096, lambda 6e-5, mixture weight 0.25: the pcg path), each
# process featurizing its own images through phase 4's chain, 64 at a
# time; (b) the ELL solve at phase 12c's widths over 4,194,304 rows (12c:
# 65,000,000); (c) the other repaired fits at their CPU tests' sizes
P21_FLAGSHIP_IMAGES, P21_FEATURIZE_CHUNK = 2000, 64
P21_WEIGHTED = dict(block_size=4096, num_iter=1, lam=6e-5, mixture_weight=0.25)
P21_ELL_ROWS = 4_194_304
# the all_gathers a fit of 21 (c) may run: TSQR's (width, width) R factors
P21_R_WIDTH = {"approximate_pca": 13, "pca": 16, "zca": 6}


def _p21_problem(rows, seed=21):
    """Phase 11d's recipe of seeded frames (class centres x 3 plus unit
    noise): every process draws the same (rows, 440) frames and labels
    and featurizes only its own."""
    from keystone_tpu_torch.loaders.text_loaders import TIMIT_DIMENSION, TIMIT_NUM_CLASSES

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((TIMIT_NUM_CLASSES, TIMIT_DIMENSION)) * 3
    y = rng.integers(0, TIMIT_NUM_CLASSES, rows)
    return (centers[y] + rng.standard_normal((rows, TIMIT_DIMENSION))).astype(np.float32), y


def _p21_rows(frames, y, lo, per, cosines, dev, host=False):
    """Rows ``lo .. lo + per`` of the TIMIT features and ±1 labels (rows
    past the frames zero): 40 ``CosineRandomFeatures`` of the JAX seeds,
    on the card as one (per, 163,840) matrix, or as one host block each."""
    from keystone_tpu_torch.loaders.text_loaders import TIMIT_NUM_CLASSES
    from keystone_tpu_torch.pipelines.speech.timit import NUM_COSINE_FEATURES, TimitConfig

    conf = TimitConfig()
    have = max(0, min(per, len(frames) - lo))
    f = torch.as_tensor(frames[lo : lo + have], device=dev)
    parts = []
    X = None if host else torch.zeros((per, cosines * NUM_COSINE_FEATURES), device=dev)
    for i in range(cosines):
        node = stats_nodes.CosineRandomFeatures.create(
            f.shape[1], NUM_COSINE_FEATURES, conf.gamma, seed=conf.seed + i, device=dev)
        block = node.apply(f)
        if host:
            h = torch.zeros((per, NUM_COSINE_FEATURES))
            h[:have] = block.cpu()
            parts.append(h)
        else:
            X[:have, i * NUM_COSINE_FEATURES : (i + 1) * NUM_COSINE_FEATURES] = block
        del block
    Y = torch.zeros((per, TIMIT_NUM_CLASSES), device=dev)
    Y[:have] = ClassLabelIndicators(TIMIT_NUM_CLASSES).apply(torch.as_tensor(y[lo : lo + have]))
    return (parts if host else X), Y


def _p21_flagship_weighted(images, mesh, dev, sync, agree, img=IMG):
    """21 (a): every process draws the same seeded images and featurizes
    its own through phase 4's chain (``jit_batch``, 64 at a time: B1-B3 on
    the card), labels each with its class under phase 4's head, and the
    weighted solver fits the sharded rows; rank 0 fits the same features
    unsharded. Returns the record."""
    from keystone_tpu_torch.parallel import mesh as mesh_lib
    from keystone_tpu_torch.parallel.dataset import all_sum

    rank, world = mesh_lib.shard_index(mesh), mesh_lib.n_data_shards(mesh)
    rec = {"images": images, **P21_WEIGHTED}
    t = time.perf_counter()
    feat, feat_dim = build_flagship_featurize_pipeline(device=dev, **dict(CONF, img=img))
    W_head, icpt = (torch.as_tensor(a, device=dev) for a in phase4_head_weights(feat_dim))
    f = feat.jit_batch(device=dev)
    raw = np.random.default_rng(23).integers(0, 256, (images, img, img, 3), dtype=np.uint8)
    rec["chain_s"] = time.perf_counter() - t

    def featurize(lo, hi, per):
        """Rows lo .. hi of the features and ±1 labels, zero past ``hi``
        up to ``per`` rows."""
        X = torch.zeros((per, feat_dim), device=dev)
        for s in range(lo, hi, P21_FEATURIZE_CHUNK):
            e = min(s + P21_FEATURIZE_CHUNK, hi)
            X[s - lo : e - lo] = f(raw[s:e])
        cls = torch.argmax(X[: hi - lo] @ W_head + icpt, dim=1)
        Y = torch.zeros((per, CLASSES), device=dev)
        Y[: hi - lo] = ClassLabelIndicators(CLASSES).apply(cls)
        return X, Y, cls

    per = -(-images // world)
    lo, hi = rank * per, min(images, (rank + 1) * per)
    _cuda.reset_launches()
    sync()
    t = time.perf_counter()
    X, Y, cls = featurize(lo, hi, per)
    sync()
    rec["featurize_s"] = time.perf_counter() - t
    rec["chunks"] = -(-(hi - lo) // P21_FEATURIZE_CHUNK)
    rec["captures"] = f.captures
    rec["launches"] = dict(_cuda.LAUNCHES)
    est = weighted_ls.BlockWeightedLeastSquaresEstimator(**P21_WEIGHTED)

    def fit(data, labels):
        mesh_lib.reset_stats()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        model = est.fit(data, labels)
        sync()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        return model, time.perf_counter() - t0, {k: list(v) for k, v in mesh_lib.STATS.items()}, peak

    sharded = (Dataset.from_array(X, n=images, mesh=mesh), Dataset.from_array(Y, n=images, mesh=mesh))
    if dev.type == "cuda":  # warm: the timed fits find the solver libraries set up
        est.fit(*sharded)
    model, rec["fit_s"], rec["collectives"], rec["peak_bytes"] = fit(*sharded)
    rec["pcg_iterations"] = int(model.solver_info["pcg_iterations"])
    W, b = model.W.clone(), model.intercept.clone()
    rec["identical_on_every_rank"] = agree(W) and agree(b)
    right = (torch.argmax(X[: hi - lo] @ W + b, dim=1) == cls).float().sum().reshape(1)
    (right,) = all_sum(mesh, right)
    rec["train_top1"] = float(right) / images
    rec["finite"] = bool(torch.isfinite(W).all() and torch.isfinite(b).all())
    if rank == 0:
        if world > 1:
            X, Y, _ = featurize(0, images, images)
        with mesh_lib.use_mesh(mesh_lib.make_mesh(ranks=[rank])):
            ref, rec["unsharded_fit_s"], _, rec["unsharded_peak_bytes"] = fit(
                Dataset.from_array(X), Dataset.from_array(Y))
        rec["equal_unsharded"] = bool(torch.equal(W, ref.W) and torch.equal(b, ref.intercept))
        rec["max_abs_diff"] = float((W - ref.W).abs().max())
    return rec


def _p21_ell(rows, mesh, dev, sync, agree, d=1024, nnz=5, k=2, lam=1e-2):
    """21 (b): the ELL solve at phase 12c's widths on sharded rows (each
    process draws the same rows on its card and keeps its own), and rank 0's
    unsharded fit of all of them."""
    from keystone_tpu_torch.ops.learning import sparse_ell
    from keystone_tpu_torch.parallel import mesh as mesh_lib

    rank = mesh_lib.shard_index(mesh)
    g = torch.Generator(device=dev).manual_seed(21)
    idx = torch.randint(0, d, (rows, nnz), generator=g, device=dev, dtype=torch.int32)
    vals = torch.randn((rows, nnz), generator=g, device=dev, dtype=torch.bfloat16)
    Y = torch.randn((rows, k), generator=g, device=dev, dtype=torch.bfloat16)
    est = sparse_ell.EllLeastSquaresEstimator(d=d, lam=lam)
    rec = {"rows": rows, "d": d, "nnz": nnz, "k": k, "lam": lam}

    def fit(data):
        mesh_lib.reset_stats()
        sync()
        t0 = time.perf_counter()
        W = est.fit(data, Dataset.from_array(Y)).W
        sync()
        return W, time.perf_counter() - t0, {k_: list(v) for k_, v in mesh_lib.STATS.items()}

    sharded = sparse_ell.ell_dataset(idx, vals).shard(mesh)
    if dev.type == "cuda":  # warm, as in (a)
        est.fit(sharded, Dataset.from_array(Y))
    W, rec["fit_s"], rec["collectives"] = fit(sharded)
    rec["identical_on_every_rank"] = agree(W)
    rec["finite"] = bool(torch.isfinite(W).all())
    if rank == 0:
        with mesh_lib.use_mesh(mesh_lib.make_mesh(ranks=[rank])):
            ref, rec["unsharded_fit_s"], _ = fit(sparse_ell.ell_dataset(idx, vals))
        rec["equal_unsharded"] = bool(torch.equal(W, ref))
        rec["max_abs_diff"] = float((W - ref).abs().max())
    return rec


def _p21_other_fits(mesh, dev, sync, agree):
    """21 (c): a check of the other repaired fits' code paths on the card,
    at their CPU tests' sizes (too small for their times to say anything of
    the card, so none is kept), sharded and (rank 0) unsharded: the
    per-class weighted solver, logistic regression, the sketch and the
    local PCA, ZCA, KRR and dense L-BFGS."""
    from keystone_tpu_torch.ops.learning import classifiers, lbfgs, zca
    from keystone_tpu_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(21)
    cls = rng.integers(0, 4, 50)
    Xw = ((rng.standard_normal((4, 10)) * 2)[cls] + rng.standard_normal((50, 10))).astype(np.float32)
    Yw = 2.0 * np.eye(4, dtype=np.float32)[cls] - 1.0
    Xl = rng.standard_normal((202, 4)).astype(np.float32)
    yl = (Xl[:, 0] + 0.5 * Xl[:, 1] > 0).astype(np.int32)
    Xp = (rng.standard_normal((122, 3)) @ rng.standard_normal((3, 16))
          + 0.01 * rng.standard_normal((122, 16))).astype(np.float32)
    Xk, Yk = (rng.standard_normal((62, m)).astype(np.float32) for m in (4, 3))
    Ar, br = (rng.standard_normal((202, m)).astype(np.float32) for m in (6, 2))
    Xz = (rng.standard_normal((102, 6)) @ rng.standard_normal((6, 6))).astype(np.float32)
    fits = {
        "per_class_weighted": lambda sh: weighted_ls.PerClassWeightedLeastSquaresEstimator(
            4, 2, 0.1, 0.6).fit(sh(Xw), sh(Yw)).W,
        "logistic_regression": lambda sh: classifiers.LogisticRegressionEstimator(
            2, num_iters=50).fit(sh(Xl), sh(yl)).W,
        "approximate_pca": lambda sh: pca.ApproximatePCAEstimator(3, seed=0).fit(sh(Xp)).pca_mat,
        "pca": lambda sh: pca.PCAEstimator(3).fit(sh(Xp)).pca_mat,
        "zca": lambda sh: zca.ZCAWhitenerEstimator(eps=1e-6).fit(sh(Xz)).whitener,
        "kernel_ridge": lambda sh: krr.KernelRidgeRegression(
            krr.GaussianKernelGenerator(0.5), 0.1, block_size=16, num_epochs=5).fit(
                sh(Xk), sh(Yk)).model,
        "dense_lbfgs": lambda sh: lbfgs.DenseLBFGSwithL2(
            num_iterations=100, reg_param=0.1, fit_intercept=False,
            convergence_tol=1e-10).fit(sh(Ar), sh(br)).W,
    }
    rank = mesh_lib.shard_index(mesh)
    out = {}
    for name, fit in fits.items():
        mesh_lib.reset_stats()
        W = fit(lambda a: Dataset.from_array(torch.as_tensor(a).to(dev)).shard(mesh))
        r = {"collectives": {k: list(v) for k, v in mesh_lib.STATS.items()},
             "local_n": -(-len(Xk) // mesh_lib.n_data_shards(mesh)),
             "identical_on_every_rank": agree(W), "finite": bool(torch.isfinite(W).all())}
        if rank == 0:
            with mesh_lib.use_mesh(mesh_lib.make_mesh(ranks=[rank])):
                ref = fit(lambda a: Dataset.from_array(torch.as_tensor(a).to(dev)))
            r["equal_unsharded"] = bool(torch.equal(W, ref))
            r["max_abs_diff"] = float((W - ref).abs().max())
        out[name] = r
    return out


def phase21_worker(rows, host_rows, cosines, epochs, host_epochs, qr_shape, shuffle_rows,
                   launched_at=None, flagship_images=P21_FLAGSHIP_IMAGES, ell_rows=P21_ELL_ROWS,
                   img=IMG):
    """One process of phase 21 (``parallel.virtual.launch``): the sharded
    fits, rank 0's unsharded ones (TIMIT's block solver in memory and from
    host blocks; then (a) the flagship's weighted solver, (b) the ELL solve
    and (c) the other repaired estimators), ``qr_q`` and
    ``device_shuffle``. Returns this process's record. Rehearse on the CPU
    at a small size: ``virtual.launch(chip_smoke.phase21_worker, 2, (8192,
    8192, 2, 2, 1, (4096, 64), 4096, None, 96, 65536, 48), device="cpu",
    timeout_s=900)`` (more TIMIT rows than a block's 4,096 columns: with
    lambda 0 a block's Gram is singular below that; 96 flagship images of
    48², 65,536 ELL rows)."""
    from keystone_tpu_torch.parallel import linalg, runtime, shuffle
    from keystone_tpu_torch.parallel import mesh as mesh_lib

    rank, world = runtime.process_index(), runtime.process_count()
    mesh = mesh_lib.current_mesh()
    dev = mesh_lib.local_device(mesh)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    rec = {"rank": rank, "world": world, "device": str(dev), "backend": torch.distributed.get_backend(),
           "jax_imported": "jax" in sys.modules,
           "start_s": None if launched_at is None else time.time() - launched_at}
    t_worker = time.perf_counter()
    frames, y = _p21_problem(max(rows, host_rows))

    def fit(data, labels, iters):
        mesh_lib.reset_stats()
        sync()
        t = time.perf_counter()
        model = block_ls.BlockLeastSquaresEstimator(4096, num_iter=iters).fit(data, labels)
        sync()
        return model, time.perf_counter() - t, {k: list(v) for k, v in mesh_lib.STATS.items()}

    def agree(W):
        """W on every process, gathered: identical bit for bit?"""
        every = mesh_lib.all_gather_rows(W[None], mesh)
        return all(torch.equal(w, W) for w in every)

    # the sharded fit in device memory
    per = -(-rows // world)
    X, Y = _p21_rows(frames[:rows], y[:rows], rank * per, per, cosines, dev)
    data = Dataset.from_array(X, n=rows, mesh=mesh)
    labels = Dataset.from_array(Y, n=rows, mesh=mesh)
    model, rec["fit_s"], rec["fit_collectives"] = fit(data, labels, epochs)
    W = model.W.clone()
    rec["fit_identical_on_every_rank"] = agree(W)
    pred = model.apply_batch(data).local().argmax(1)
    right = ((pred == Y.argmax(1)).float() * data.mask()).sum().reshape(1)
    rec["train_accuracy"] = float(mesh_lib.all_reduce_sum_(right, mesh)) / rows
    rec["finite"] = bool(torch.isfinite(W).all())
    w, k = 4096, Y.shape[1]
    block_elems = w * w + w * k + k  # one block's Gram, right-hand side, residual sum
    del X, Y, data, labels, model, pred
    if on_card:
        torch.cuda.empty_cache()
        buf = torch.ones(block_elems, device=dev)
        rec["all_reduce_block_bytes"] = block_elems * 4
        rec["all_reduce_block_ms"] = time_ms(lambda: mesh_lib.all_reduce_sum_(buf, mesh))
        del buf

    # the sharded fit from host blocks: this process's rows of each slab
    hper = -(-host_rows // world)
    blocks, Yh = _p21_rows(frames[:host_rows], y[:host_rows], rank * hper, hper, cosines, dev,
                           host=True)
    hdata = Dataset.from_host_blocks(blocks, n=host_rows, device=dev, mesh=mesh)
    hmodel, rec["host_fit_s"], rec["host_fit_collectives"] = fit(
        hdata, Dataset.from_array(Yh, n=host_rows, mesh=mesh), host_epochs)
    Wh = hmodel.W.clone()
    rec["host_fit_identical_on_every_rank"] = agree(Wh)
    del hdata, hmodel
    if world > 1:
        del blocks, Yh

    # rank 0: the same fits on the unsharded rows, one matrix at a time
    if rank == 0:
        if on_card:
            torch.cuda.empty_cache()
        X, Y = _p21_rows(frames[:rows], y[:rows], 0, rows, cosines, dev)
        ref, rec["unsharded_fit_s"], _ = fit(Dataset.from_array(X), Dataset.from_array(Y), epochs)
        rec["fit_equal_unsharded"] = bool(torch.equal(W, ref.W))
        rec["fit_max_abs_diff"] = float((W - ref.W).abs().max())
        rec["fit_within_tol"] = bool(torch.allclose(W, ref.W, **FIT_TOL))
        del X, Y, ref
        if world > 1:
            blocks, Yh = _p21_rows(frames[:host_rows], y[:host_rows], 0, host_rows, cosines, dev,
                                   host=True)
        # on a mesh of this process alone: over several, an unsharded
        # host-blocks fit shards itself (block_ls.py)
        with mesh_lib.use_mesh(mesh_lib.make_mesh(ranks=[rank])):
            href, rec["unsharded_host_fit_s"], _ = fit(
                Dataset.from_host_blocks(blocks, device=dev), Dataset.from_array(Yh), host_epochs)
        rec["host_fit_equal_unsharded"] = bool(torch.equal(Wh, href.W))
        rec["host_fit_max_abs_diff"] = float((Wh - href.W).abs().max())
        rec["host_fit_within_tol"] = bool(torch.allclose(Wh, href.W, **FIT_TOL))
        del href
    blocks = Yh = None
    if on_card:
        torch.cuda.empty_cache()

    # (a)-(c): the estimators that fit on sharded rows since the block solver
    t = time.perf_counter()
    rec["flagship_weighted"] = _p21_flagship_weighted(flagship_images, mesh, dev, sync, agree, img)
    if on_card:
        torch.cuda.empty_cache()
    rec["ell"] = _p21_ell(ell_rows, mesh, dev, sync, agree)
    if on_card:
        torch.cuda.empty_cache()
    rec["other_fits"] = _p21_other_fits(mesh, dev, sync, agree)
    rec["estimators_s"] = time.perf_counter() - t

    # qr_q at phase 13's shape on sharded rows, each from its global index
    n, d = qr_shape
    qper = -(-n // world)
    g = torch.Generator(device=dev).manual_seed(134)
    A = torch.randn((qper * world, d), generator=g, device=dev)[rank * qper : (rank + 1) * qper].clone()
    sync()
    qr_q = lambda: linalg.qr_q(A, mesh)  # noqa: E731
    qr_q()
    # ~0.34 s a call: the launches hide nothing, so three single calls
    rec["qr_q_ms"] = time_ms(qr_q, calls=1, rounds=3, warmup=0) if on_card else None
    Q, R = qr_q()
    rec["qr_r_identical_on_every_rank"] = agree(R)
    rec["ortho_err"] = float((linalg.gram(Q, mesh) - torch.eye(d, device=dev)).abs().max())
    sq = torch.stack([((Q @ R - A) ** 2).sum(), (A ** 2).sum()])
    rec["qr_rel_err"] = float(mesh_lib.all_reduce_sum_(sq, mesh).sqrt()[0] / sq.sqrt()[1])
    del A, Q, R

    # device_shuffle at the world size: phase 13's rows and 1,000 pad rows
    full = torch.randn((shuffle_rows + 1000, 1024), generator=torch.Generator(device=dev).manual_seed(13),
                       device=dev)
    full[shuffle_rows:] = 0
    sh = Dataset.from_array(full, n=shuffle_rows).shard(mesh)
    out = mesh_lib.all_gather_rows(shuffle.device_shuffle(sh.local(), shuffle_rows, 13, mesh), mesh)
    perm = torch.as_tensor(np.random.default_rng(13).permutation(shuffle_rows), device=dev)
    rec["shuffle_equal"] = bool(torch.equal(out[:shuffle_rows], full[perm])
                                and not out[shuffle_rows:].any())
    rec["shuffle_padded_rows"] = sh.padded_n
    rec["jax_imported_after"] = "jax" in sys.modules
    rec["worker_s"] = time.perf_counter() - t_worker
    return rec


def data_parallel_phase(smi, rows=P21_ROWS, host_rows=P21_HOST_ROWS, cosines=P21_COSINES,
                        epochs=P21_EPOCHS, host_epochs=P21_HOST_EPOCHS, qr_shape=P13_QR,
                        shuffle_rows=P13_CHECK_ROWS, flagship_images=P21_FLAGSHIP_IMAGES,
                        ell_rows=P21_ELL_ROWS):
    """Phase 21: ``phase21_worker`` in one process per card (NCCL)."""
    from keystone_tpu_torch.parallel import virtual

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    parent_bytes = torch.cuda.memory_allocated()
    t = time.perf_counter()
    recs = virtual.launch(phase21_worker, world,
                          (rows, host_rows, cosines, epochs, host_epochs, qr_shape, shuffle_rows,
                           time.time(), flagship_images, ell_rows),
                          device="cuda", timeout_s=P21_TIMEOUT_S)
    r0 = recs[0]
    out = {"card": smi, "world": world, "rows": rows, "host_rows": host_rows,
           "features": cosines * 4096, "phase_s": time.perf_counter() - t,
           "parent_allocated_bytes": parent_bytes, "ranks": recs}
    log(f"21 data parallel: {world} process(es), {r0['backend']}, one card each "
        f"(the parent holds {parent_bytes} bytes); TIMIT {rows} x {cosines * 4096} sharded: "
        f"fit {r0['fit_s']:.3f} s ({P21_EPOCHS} sweeps; all_reduce calls, bytes "
        f"{r0['fit_collectives'].get('all_reduce')}), unsharded {r0['unsharded_fit_s']:.3f} s, "
        f"equal bit for bit {r0['fit_equal_unsharded']} (max |diff| {r0['fit_max_abs_diff']:.3g}), "
        f"identical on every rank {all(r['fit_identical_on_every_rank'] for r in recs)}, "
        f"training accuracy {r0['train_accuracy']:.4f}; host blocks of {host_rows} rows: "
        f"{r0['host_fit_s']:.3f} s against {r0['unsharded_host_fit_s']:.3f} s unsharded, equal "
        f"{r0['host_fit_equal_unsharded']} (max |diff| {r0['host_fit_max_abs_diff']:.3g}; "
        f"all_reduce {r0['host_fit_collectives'].get('all_reduce')}); one block's all_reduce "
        f"({r0['all_reduce_block_bytes']} bytes) {r0['all_reduce_block_ms']:.4f} ms; qr_q at "
        f"{qr_shape} {r0['qr_q_ms']:.3f} ms, max|QᵀQ − I| {r0['ortho_err']:.3g}, ‖QR − A‖/‖A‖ "
        f"{r0['qr_rel_err']:.3g}; device_shuffle equal {r0['shuffle_equal']}; phase "
        f"{out['phase_s']:.3f} s (rank 0 up {r0['start_s']:.3f} s after the launch, its work "
        f"{r0['worker_s']:.3f} s), on {smi}")
    fw, ell, other = r0["flagship_weighted"], r0["ell"], r0["other_fits"]
    log(f"21a the flagship's weighted fit on sharded rows ({fw['images']} images of {IMG}², "
        f"{CLASSES} classes, 8,192 features, {P21_WEIGHTED}): featurized in {fw['chunks']} chunks "
        f"of {P21_FEATURIZE_CHUNK} in {fw['featurize_s']:.3f} s (chain built {fw['chain_s']:.3f} s; "
        f"{fw['captures']} graph captures; launches {fw['launches']}); fit {fw['fit_s']:.3f} s ({fw['pcg_iterations']} CG "
        f"iterations at most; collectives {fw['collectives']}), peak {fw['peak_bytes']} bytes; "
        f"unsharded {fw['unsharded_fit_s']:.3f} s (peak {fw['unsharded_peak_bytes']}), equal bit "
        f"for bit {fw['equal_unsharded']} (max |diff| {fw['max_abs_diff']:.3g}); training top-1 "
        f"{fw['train_top1']:.4f}; on {smi}")
    log(f"21b the ELL solve on sharded rows ({ell['rows']} x {ell['d']}, nnz {ell['nnz']}, k "
        f"{ell['k']}, lambda {ell['lam']}): {ell['fit_s']:.3f} s (collectives "
        f"{ell['collectives']}), unsharded {ell['unsharded_fit_s']:.3f} s, equal bit for bit "
        f"{ell['equal_unsharded']} (max |diff| {ell['max_abs_diff']:.3g}); on {smi}")
    log("21c the other fits' code paths at their CPU tests' sizes, sharded against unsharded "
        "(equal, max |diff|, collectives): "
        + "; ".join(f"{k} {v['equal_unsharded']} {v['max_abs_diff']:.3g} {v['collectives']}"
                    for k, v in other.items()))
    for r in recs:
        assert not r["jax_imported"] and not r["jax_imported_after"], r["rank"]
        assert r["backend"] == "nccl" and r["device"] == f"cuda:{r['rank']}", r
        assert r["fit_identical_on_every_rank"] and r["host_fit_identical_on_every_rank"], r
        assert r["qr_r_identical_on_every_rank"] and r["shuffle_equal"] and r["finite"], r
        for name, e in [("flagship", r["flagship_weighted"]), ("ell", r["ell"]),
                        *r["other_fits"].items()]:
            assert e["identical_on_every_rank"] and e["finite"], e
            # no fit gathers X: its sums cross processes as all_reduce; the
            # PCAs' and ZCA's tree QRs gather only (width, width) R factors
            gathered = e["collectives"].get("all_gather", [0, 0, 0])
            assert "all_reduce" in e["collectives"], e
            assert gathered[2] <= P21_R_WIDTH.get(name, 0) ** 2 * 4, e
            # and no row crosses processes (Dataset.rows_piece), but KRR's:
            # each of its rows at most once an epoch, and once more for the
            # cached kernel, with its K_BB and Y_B rows (4 wide, k 3, block 16)
            moved = e["collectives"].get("rows", [0, 0, 0])[1]
            assert moved <= (4 * 6 * e["local_n"] * (4 + 2 + 16 + 3)
                             if name == "kernel_ridge" else 0), e
    # G and AᵀY together, in one all_reduce smaller than a process's rows
    assert ell["collectives"]["all_reduce"][0] == 1, ell
    assert ell["collectives"]["all_reduce"][2] < ell["rows"] // world * ell["nnz"] * 6, ell
    # B1-B3 ran in the worker's featurize: 4 / 1 / 2 launches a chunk, and
    # each capture's warm pass and checking replay one chunk's more each
    # (workflow/cuda_graph.py)
    calls = fw["chunks"] + 2 * fw["captures"]
    assert fw["launches"] == {"sift_bin_sample": 4 * calls, "plane_sandwich": calls,
                              "fisher_vector_stats": 2 * calls}, fw
    assert r0["train_accuracy"] > P21_MIN_TRAIN_ACC, r0["train_accuracy"]
    assert r0["ortho_err"] <= MAX_ORTHO_ERR and r0["qr_rel_err"] <= RTOL_QR, r0
    if world == 1:  # an all_reduce over one rank changes no bytes
        assert r0["fit_equal_unsharded"] and r0["host_fit_equal_unsharded"], r0
        assert fw["equal_unsharded"] and ell["equal_unsharded"], (fw, ell)
        assert all(v["equal_unsharded"] for v in other.values()), other
    assert r0["fit_within_tol"] and r0["host_fit_within_tol"], r0
    return out


def data_parallel_only():
    """``--data-parallel``: phase 21 alone, its record under chiprun_out."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    _cuda.build()  # all nvccs at once; the workers load the libraries
    rec = data_parallel_phase(smi)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "data_parallel.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def fail_summary(e):
    """A failed run's traceback, then one line naming the phase function
    that ``main`` was in and the script's deepest line, as the last line
    of stderr; exit 1 at once, so that no thread's later output (a
    client of a server the phase's cleanup stopped) buries it."""
    import traceback

    traceback.print_exception(e)
    frames = traceback.extract_tb(e.__traceback__)
    here = os.path.abspath(__file__)
    ours = [f for f in frames if os.path.abspath(f.filename) == here]
    at_main = next((i for i, f in enumerate(frames) if f.name == "main"
                    and os.path.abspath(f.filename) == here), None)
    phase = (frames[at_main + 1].name if at_main is not None and at_main + 1 < len(frames)
             else "main")
    where = f"chip_smoke.py:{ours[-1].lineno} ({ours[-1].name})" if ours else "?"
    sys.stdout.flush()
    print(f"chip_smoke: failed in {phase}, at {where}: {type(e).__name__}: {str(e)[:2000]}",
          file=sys.stderr, flush=True)
    os._exit(1)


def main():
    # -- 1. the card ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.build()
    log(f"built {sorted(_cuda.SOURCES)} in {time.perf_counter() - t0:.3f} s")
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
             for name, text in _cuda.BUILD_LOGS.items()}
    for name, lines in ptxas.items():
        for ln in lines:
            log(f"ptxas {name}: {ln}")
    # B3's tiled path runs its products on the tensor cores: HMMA in its
    # norm and statistics kernels' SASS
    hmma = hmma_counts(_cuda.build(["fv_stats"])["fv_stats"])
    log(f"HMMA instructions in fv_stats.cu's kernels: {hmma}")
    assert hmma.get("fv_norm_kernel", 0) > 0 and hmma.get("fv_stats_kernel", 0) > 0, hmma

    # -- 3. kernels against their plain versions ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    check_ragged(dev, gen)
    log("kernels match their plain versions at ragged shapes; past the old limits:")
    wide = check_wide(dev, gen)
    torch.cuda.empty_cache()
    rows = check_kernels(dev, gen)
    for r in rows:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"{r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
            f"library {r['library_ms']:.3f} = {r['library_ms'] / r['ms']:.2f}x, "
            f"bound {r['bound_ms']:.3f} by {r['bound_by']}, share "
            f"{r['bound_share']:.3f}), max abs err {r['max_abs_err']:.3g} "
            f"[{r['shapes']}] on {smi}")
    torch.cuda.empty_cache()

    # -- 4, 5. serve ----------------------------------------------------
    served, feat, model = serve(dev, smi)
    for r in rows:
        r["launches"] = served["launches"][r["name"]]
    torch.cuda.empty_cache()

    # -- 6. train, then serve -------------------------------------------
    keep = {}  # phase 11c's inputs, from phases 6 and 9
    t0 = time.perf_counter()
    trained = train_then_serve(dev, smi, keep=keep)
    solver_xy = keep.pop("solver_xy")
    solver_chol = keep.pop("solver_chol")  # its CPU side runs beside phases 7 to 13
    trained["phase_s"] = time.perf_counter() - t0
    log(f"phase 6 in {trained['phase_s']:.3f} s on {smi}")
    for r in rows:
        r["fit_launches"] = trained["launches_fit"][r["name"]]
    fv_row = next(r for r in rows if r["name"] == "fisher_vector_stats")
    fv_row["fitted_gmm_max_abs_err"] = max(e["max_abs_err"] for e in trained["fv_fitted"])
    torch.cuda.empty_cache()

    # -- 7. serve under a request stream --------------------------------
    streamed = serve_stream(dev, smi, feat, model)
    torch.cuda.empty_cache()

    # -- 8. real image files --------------------------------------------
    files = real_image_files(dev, smi)
    for r in rows:
        r["phase8_launches"] = files["launches"][r["name"]]
    torch.cuda.empty_cache()

    # -- 9. VOCSIFTFisher at the paper's widths ---------------------------
    voc_rec = voc_sift_fisher(dev, smi, keep=keep)
    for r in rows:
        r["phase9_fit_launches"] = voc_rec["fit_launches"][r["name"]]
        r["phase9_score_launches"] = voc_rec["score_launches"][r["name"]]
    torch.cuda.empty_cache()

    # -- 10. the random-features image apps (no kernel of this repo) -----
    _cuda.reset_launches()
    rf = random_features(dev, smi)
    for r in rows:
        r["phase10_launches"] = _cuda.LAUNCHES[r["name"]]
    log(f"launches in phase 10: {dict(_cuda.LAUNCHES)}")
    torch.cuda.empty_cache()

    # -- 11. fits past the card's memory, the other estimators, TIMIT ----
    t0 = time.perf_counter()
    past = {"streamed": streamed_fit(dev, smi)}
    largest = past["streamed"]["streams"][P11_STREAMS[-1]]
    for r in rows:
        r["phase11_launches"] = largest["launches"][r["name"]]
        r["phase11_launches_per_chunk"] = largest["launches_per_chunk"][r["name"]]
    torch.cuda.empty_cache()
    past["auto_cache"] = auto_cache_fit(dev, smi)
    torch.cuda.empty_cache()
    past["estimators"] = other_estimators(dev, smi, keep)
    del keep
    torch.cuda.empty_cache()
    past["timit"] = timit_at_width(dev, smi)
    past["phase_s"] = time.perf_counter() - t0
    log(f"phase 11 in {past['phase_s']:.3f} s on {smi}")
    torch.cuda.empty_cache()

    # -- 12. the text apps and the ELL solver (no kernel of this repo) ---
    _cuda.reset_launches()
    text = text_apps(dev, smi)
    for r in rows:
        r["phase12_launches"] = _cuda.LAUNCHES[r["name"]]
    log(f"launches in phase 12: {dict(_cuda.LAUNCHES)}")
    torch.cuda.empty_cache()

    # -- 13. the last app and the remaining operators (no kernel of this repo)
    _cuda.reset_launches()
    last = last_app_and_operators(dev, smi)
    for r in rows:
        r["phase13_launches"] = _cuda.LAUNCHES[r["name"]]
    log(f"launches in phase 13: {dict(_cuda.LAUNCHES)}")
    torch.cuda.empty_cache()
    # phase 6's Cholesky solve, card against the CPU process started there
    trained["checks"]["solver_chol"] = finish_cpu_solver(*solver_chol)
    del solver_chol

    # -- 14. the gateway over HTTP, its entry, and the repairs ------------
    gateway = gateway_phase(dev, smi, feat, model, solver_xy)
    del solver_xy
    for r in rows:
        r["phase14_launches"] = gateway["served"]["load"]["launches"][r["name"]]
        r["phase14_launches_per_dispatch"] = gateway["served"]["load"]["launches_per_dispatch"][r["name"]]
    torch.cuda.empty_cache()

    # -- 15. the fleet tier and the model zoo ------------------------------
    _cuda.reset_launches()
    fleet_zoo = fleet_and_zoo(dev, smi)
    for r in rows:
        r["phase15_launches"] = _cuda.LAUNCHES[r["name"]]
    log(f"launches in phase 15 (this process: the zoo's engines): {dict(_cuda.LAUNCHES)}")
    # the zoo's flagship chain is vocab 16: the plain FV node, as in JAX
    assert _cuda.LAUNCHES["sift_bin_sample"] > 0 and _cuda.LAUNCHES["plane_sandwich"] > 0
    torch.cuda.empty_cache()

    # -- 16. the load generator and the online model lifecycle ------------
    lifecycle = loadgen_and_lifecycle(dev, smi, feat, model)
    for r in rows:
        r["phase16a_launches"] = lifecycle["chaos"]["launches"][r["name"]]
        r["phase16a_launches_per_request"] = lifecycle["chaos"]["launches_per_request"][r["name"]]
    torch.cuda.empty_cache()

    # -- 17. cold start, model sharding and elasticity ---------------------
    _cuda.reset_launches()
    elastic = cold_start_sharding_elasticity(dev, smi, feat, model)
    for r in rows:
        # this process (17b's in-process engines, 17c's gateways), the fresh
        # process built from the store (one bucket-64 replay), and the
        # autoscaled replicas (vocab 16: B1 and B2 only)
        r["phase17_launches"] = {
            "this_process": _cuda.LAUNCHES[r["name"]],
            "fresh_from_store": elastic["aot"]["store"]["launches"][r["name"]],
            "replicas": {n: v["launches"][r["name"]]
                         for n, v in elastic["autoscale"]["replicas"].items()},
        }
    log(f"launches in phase 17: {[(r['name'], r['phase17_launches']) for r in rows]}")

    # -- 18. the port's tools: keystone-lint and bench-diff ---------------
    tools = lint_and_bench_diff(smi, rows)

    # -- 19. serve-bench: the serving benchmark rows ------------------------
    bench = serve_bench(smi)
    for r in rows:
        r["phase19_launches"] = bench["featurize"]["launches"][r["name"]]

    # -- 20. FittedPipeline.jit_batch: one CUDA graph per batch shape -------
    jitted = jit_batch_phase(dev, smi, feat, model)
    del feat, model
    for r in rows:
        r["phase20_launches_per_call"] = jitted["launches_per_call"][r["name"]]

    # -- 21. the data-parallel layer: one process per card, NCCL ------------
    data_parallel = data_parallel_phase(smi)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": rows, "wide": wide, "serve": served, "train": trained,
                   "stream": streamed, "files": files, "voc": voc_rec, "random_features": rf,
                   "past_the_card": past, "text": text, "last_app": last,
                   "gateway": gateway, "fleet_zoo": fleet_zoo, "loadgen_lifecycle": lifecycle,
                   "elastic": elastic, "tools": tools, "serve_bench": bench, "jit_batch": jitted,
                   "data_parallel": data_parallel, "ptxas": ptxas,
                   "get_resets": GET_RESETS}, f,
                  indent=1, default=str)
    # the fit's launches and B3's error with the fitted GMMs are in
    # chip_smoke.json beside these
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gateway-clients"]:
        gateway_clients(*json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["--startup-split"]:
        startup_split(json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["--cpu-solver"]:
        cpu_solver(json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["--overlap-runs"]:
        overlap_runs(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--cold-start-runs"]:
        cold_start_runs(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--autoscale-runs"]:
        autoscale_runs(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--featurize-runs"]:
        featurize_runs(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--featurize-processes"]:
        featurize_processes(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--featurize-process"]:
        featurize_process(sys.argv[2])
    elif sys.argv[1:2] == ["--data-parallel"]:
        data_parallel_only()
    else:
        try:
            main()
        except Exception as e:
            fail_summary(e)
