#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of code2vec on one NVIDIA H100.

    python3 chip_smoke.py [--json_out PATH]

Phases (each one that fails prints its traceback; any failure exits 1 and
the final result line is not printed):

1. device  — require CUDA and compute capability 9.0; print the card's
   name and power limit (``nvidia-smi``) and the torch/CUDA versions;
2. build   — compile every ``code2vec_tpu_torch/csrc/*.cu`` with ``nvcc``
   for sm_90a (one process per source, in parallel; beside them the Java
   extractor from ``extractor/src`` with ``g++``, its seconds kept for the
   extract phase), then read the SASS of
   the encode-pool library (``cuobjdump``): every encode kernel (online,
   which K3's materialize also runs; score and fixed-max of two_pass; for
   each row source) must hold TF32 ``HMMA`` instructions;
3. kernels — first the launch floor: a one-element ``torch`` add timed as
   every kernel is, the least any launch here can read; then K1 (pool, at
   each shape with the CTAs per row its grid policy gives), K1b (its
   backward, from the forward's weights and code vector, with the CTAs of
   its persistent grid: d_ctx within 1e-5, d_attn within rtol 1e-4;
   library: autograd of the plain pool), K2
   (encode-pool over gathered rows) and K3
   (encode-pool with the gather inside; f32, bf16 and int8 tables) at the
   top11 widths, B in {1, 8, 64} x L in {1, 37, 200}; K4 (the streamed
   softmax, online and two_pass x f32/bf16/int8) at B in {1, 8, 64} x L in
   {512, 1024, 2048}; the first row of every batch a full bag, PAD tails
   in the others and, when B > 1, one all-masked row; each
   held against its plain PyTorch version (max |err| <= 1e-5; f32 on the
   plain side with TF32 off, 3xTF32 on the tensor cores in K2-K4) and timed
   with CUDA events (median of 30 launches after warmup, L2 flushed before
   each launch);
4. serve   — a top11-width model dir with random weights from a seed,
   served through the port's own ``build_server`` with each kernel route
   (K3 with f32, int8 and bf16 tables, K2, K1): 96 predict/embed requests
   per route, bag lengths 1-400 (over-long bags are subsampled), part one
   at a time and part pipelined so they coalesce. Every response must be
   ok and finite, every code vector must match the same model run without
   kernels on the card (rtol 2e-4, atol 2e-5), top-1 labels must agree,
   nothing may warm after startup, and each route's kernel must have been
   launched. The launch counts are reset just before each route is served
   and read just after;
5. longbag — the same model with the long-bag rungs that
   ``derive_longbag_ladder`` gives above 200 (512, 1024, 2048), served
   through ``--longbag_widths`` once per K4 variant (online and two_pass x
   f32/bf16/int8 tables): 96 requests, three quarters with 1-200 contexts
   and one quarter with 201-2048 (log-uniform, one of 2048), mixed
   predict/embed, one at a time and pipelined. Code vectors within 1e-5 of
   the model without kernels, K4 launched, nothing warmed after startup;
6. retrieval — a synthetic clustered corpus made as ``bench.py`` makes its
   ANN corpus (1,000,000 rows at dim 100, the served encode width; 8,192
   true clusters, noise 0.12), an IVF-PQ index built on the card (n_list
   1,000, m 20, shortlist 256) and saved; K5 held against its plain
   version at Q in {1, 8, 64} x n_probe in {8, 16} on the index's shapes
   (fastest and slowest launch, the CTA grid its policy gives);
   then a server with ``--retrieval_backend ann`` answers 64 ``neighbors``
   queries one at a time in the ``vector`` form on ``exact`` and on
   ``ann``, and 16 in the ``contexts`` form on each. Reports p50/p99 per
   backend, recall@10 of ann against exact at n_probe 8/16/32, the probed
   fraction, and fails if the ann shortlists differ (as id sets) from the
   same searcher with the plain scoring or K5 never launched; last, one
   ``neighbors`` query's search split into the device time of each stage
   (coarse matmul, topk, LUT einsum, K5, add + topk, id gather, copy to
   the host) beside the host's wall time of the whole search;
6b. serve_control (after retrieval) — (a) the coalescing invariant the
   hot-swap gate holds: on every serving route (K3 f32/bf16/int8 with K4
   online at the long-bag rungs, K4 online and two_pass at every rung, K2,
   K1) 64 requests at each rung 25/50/100/200 (and 512/1024/2048 on the
   fused routes), each request's code vector from a micro-batch of 64 and
   of 8 bitwise its batch-1 vector, its logits within rtol 1e-5 / atol
   1e-6, and one micro-batch mixing every rung likewise; then the plain
   route (the same weights, no kernel) the same way, held to the same
   gate (0 rows may move, the mixed-width batch too); (b) hot-swap: the
   model dir A (the serve phase's) served with a trickle of requests on a
   thread of its own, then a ``reload`` of B (random weights from seed 1,
   written beside it) polled through ``swap_status``, ``rollback``, a
   ``reload`` of a dir whose W holds a NaN (``swap_failed``, A still
   active) and a third swap: zero failed requests, B's answers within the
   serve tolerances of B run plain, the rolled-back answers bitwise A's,
   ``memory_allocated`` (cuBLAS workspaces dropped) after the third swap
   within 16 MB of two resident generations, two generations on the
   handle ledger, ``flights`` non-empty; build and validation seconds and
   the trickle's p50/p99 before, during and after; (c) HTTP on port 0 over
   the retrieval phase's IVF-PQ index: the data and control ops 200, a bad
   body / a missing field / nothing to roll back 400, a flood while the
   engine is held 429, a NaN reload 500, an ann reload's golden recall@10
   against its 0.9 floor, ``/healthz``, ``/metrics``, p50/p99 per op over
   HTTP beside the same server in process; (d) the serve CLI on stdio as a
   subprocess: 64 pipelined requests, SIGTERM after the last, 64 answers
   and exit 0; (e) a fleet of 2 replicas on the card behind the router
   (result cache 64 MB) under a trickle of distinct requests: a rolling
   reload to B and a rollback with no failed request and never two
   replicas swapping at once, a repeated request from the cache with no
   replica launching, the capacity block, p50/p99 through the router
   beside the single server's. Launches: the coalescing check's, the
   in-process parts' (counts reset after the check, read at the end) and
   the replicas' from their ``health`` payloads;
7. train   — ``train()`` of the port at the top11 widths (a corpus made
   as ``bench.py`` makes its own: 8,192 methods, mean 120 contexts, the
   top11 vocab and label widths), batch 1024, bag 200, dropout 0.25, for
   2 epochs on each route: plain (no kernel), pool_only (K1 + K1b),
   gather_split (K2 with the keep mask), fused (K3 with the keep mask);
   per epoch the loss, subtoken F1, steps/s and real contexts/s of the
   train steps after the warm one; losses finite and each route's kernels
   launched (counts reset just before each run, read just after). Then a
   3-step differential from one set of weights, dropout 0: each kernel
   route's losses within rtol 1e-4 and gradients within atol 1e-5 / rtol
   1e-3 of the plain route's; and the fused run's model dir served by
   ``build_server`` (16 predict requests against the trained model run
   plain). K1b (at B in {1, 64, 1024} x L in {1, 37, 200}) and the masked
   K2/K3 (at the kernel shapes plus 1024 x 200, timed beside the maskless
   launch) are checked and timed in the kernels phase, and the masked K4
   (online and two_pass, at B in {1, 8, 64} x L in {1, 37, 200, 513, 2048}
   plus the long-bag train shape 256 x 4096, against
   ``streamed_reference_forward`` with the same mask);
7b. train_elastic (after train) — elastic training at the train phase's
   recipe (7 steps an epoch), the corpus written as ``corpus.txt`` and
   loaded as the CLI loads it: (a) fused with no mid-epoch save, with
   ``--checkpoint_every_steps 3`` and the same with ``--async_checkpoint``:
   the three histories (every metric but the clocks) and final weights
   bitwise equal; the checkpoint's bytes, each save's blocking ms (the whole
   save synchronously, the snapshot asynchronously), the persist seconds and
   each run's ``epoch_seconds``; (b) ``train_step@11:raise`` (epoch 1's
   4th step, after its step-3 save) and ``--resume``, which replays 3
   batches: bitwise (a)'s, the replay's seconds; (c) pool_only (K1 + K1b)
   with ``--prefetch_batches 2`` and ``train_step@9:sigterm``: ``train()``
   returns, the slot's cursor at epoch 1 step 2, the seconds from the
   signal to the return, the resume bitwise an uninterrupted pool_only
   run; (d) the CLI in a subprocess, ``train_step@11:kill`` (exit -9) then
   ``--resume`` (exit 0): its history bitwise (a)'s; (e) ``--device_epoch``
   on fused, ``epoch_start@2:sigterm``: a boundary save, and its resume
   bitwise an uninterrupted device run. Every run launches its route's
   kernels (counts reset just before it, read just after);
7c. train_hpo (after train_elastic) — the search's paths: (a) K3 masked
   (keep 0.5 and 0.9) and its VJP, K1 and K1b at B = 256, L = 200 and
   H in {104, 105, 173, 256, 257, 300} (the last width whose W stays in
   K2-K4's shared memory, the first streamed one, H % 4 != 0 on K1/K1b,
   both sides of K1b's register cap), each against its plain version
   (forwards within 1e-5, K1b's d_ctx within 1e-5 and d_attn within rtol
   1e-4, the VJP within the train differential's bar) and timed; (b)
   ``find_optimal_hyperparams`` on the train phase's corpus at the top11
   widths, 4 trials of 2 epochs on fused (TPE after 2 startup trials,
   median pruning after 1): per trial its params, state, value, warm
   epoch_seconds, launches (reset at its ``trial`` event, read at its
   ``trial_result``) and ``memory_allocated``; every trial launches K3
   masked, no loss non-finite, no checkpoint or vectors written, memory
   after the last trial within 64 MiB of the first's; then the space's
   corners run as trials (encode 100 at batch 1024, encode 300 at batch
   2048), their epoch_seconds; (c) the CLI on
   pool_only with ``--env floyd --events_dir --trace_dir --profile_dir
   --profile_steps 4 --prefetch_batches 2`` in a subprocess: the manifest
   first, naming the card and its peak; the floyd lines equal to the epoch
   events' metrics; device bytes in use above 0 and no recompile in each
   epoch event; each sampled step's mfu in (0, 1]; the trace's
   host_build / h2d / train_step / train_pass / eval_pass spans, the
   producer's thread apart from the step's; the profiler's trace of epoch
   2 naming K1's and K1b's kernels; (d) the projector TSVs of its
   code.vec, one row a vector; and a two-trial search through the CLI
   with ``--gpu 0 --num_workers 4``. Each part's seconds are printed;
7d. train_mesh (after train_hpo) — the ``(data, model, ctx)`` mesh: (a)
   the port's collective Functions (``parallel/distributed.py``) and their
   backwards over an NCCL group of one rank on ``cuda:0``, the NCCL version
   printed; (b) two processes this script starts (``--mesh_worker``), each
   ``LOCAL_RANK`` 0 with a gloo group formed before ``train()``,
   time-sliced on the one card, through the train phase's corpus and recipe
   (top11 widths, batch 1024, bag 200, dropout 0.25, one epoch, tables
   padded to 2): data=2 on fused (K3 masked and its VJP, K3 in eval) and on
   pool_only (K1/K1b), model=2 on fused and on gather_split (K2 masked over
   the row-sharded gather), ``--host_shard_corpus`` at data=2,
   ``--device_epoch --shard_staged_corpus`` at data=2, and a mid-epoch save
   at data=2 (SIGTERM to rank 0 after step 4, the ranks' common stop)
   restored onto model=2 and resumed. The ranks' per-step losses equal
   bitwise; data=2 and model=2 on fused and pool_only within rtol 2e-5 a
   step of the same run at world 1; each rank of the sharded staging holds
   0.4-0.6 of the bytes; every restored tensor bitwise the saved one, the
   resumed steps and epoch loss within rtol 2e-5 of world 1; lazy tables
   at model=2 on fused (K3 masked, K3) and on gather_split (K2 masked),
   each within rtol 2e-5 a step of the same lazy route at world 1. Printed: a
   profiled data=2 step's ms and its gradient all-reduce's ms and bytes
   (gloo on one time-sliced card, not NCCL across cards). (c) the same pair
   serving at model=2 over the retrieval phase's 1,000,000-row corpus and
   IVF-PQ index (``serve/retrieval.py``, ``ann/index.py`` on a mesh): the
   exact top-10 of 64 queries, ids equal to one device's wherever the
   scores differ by more than 1e-5; the ann shortlists equal to one
   device's (``same_shortlist``), each rank launching K5 on its cells;
   a data=2 ``build_index`` of a 100,000-row slice bitwise the world-1
   build; per-query ms (gloo on one time-sliced card);
7e. autotune (after train_mesh) — the kernel-schedule autotuner at the
   top11 widths (synthetic tables of 360,633 rows): (a) six forward keys
   (1024 x 200 f32; 1 x 200 and 64 x 200, f32 and int8 tables; 64 x 1024
   f32) and the retrieval index's LUT key (m 20, n_list 1,000, its
   capacity, shortlist 256) tuned into a fresh cache file, every variant
   (plain, K1, K2, K3, K4 online and two_pass; K5) timed, one line a key
   with each variant's ms, its winner (gated: the fastest finite timing)
   and its skips (one not in ``AT_EXPECTED_SKIPS`` fails); each variant's
   code vectors at 64 x 200 within the serve bar of the plain route's; (b)
   the tuner's CLI again with ``--expect-cached`` (the LUT key as ``python
   -m``): exit 0, no timing run; (c) one epoch of the train phase's corpus
   and recipe through the CLI with ``--pallas_impl auto --autotune_cache``
   and on the fixed route the 1024 x 200 schedule names: every step's loss
   bitwise equal, the auto run's launches that route's kernels and no
   other; (d) engines under ``pallas_impl="auto"`` over the serve phase's
   model dir (f32 and int8 tables, batch 1 and 64 at width 200): every
   shape's provenance cached with its tuned schedule, its answers bitwise
   the fixed route's; (e) a searcher built with the cache: K5 launched,
   shortlists equal to the default searcher's;
8. train_bucketed — bucketed training on ``bench.py``'s ``--bucket-ab``
   corpus (30,720 methods, mean 60 contexts, lognormal sigma 1.0, max 400,
   top11 widths; batch 1024, bag 200, the derived ladder, dropout 0.25, 2
   epochs on plain, pool_only, gather_split and fused): losses equal across
   routes within rtol 1e-4 and each kernel launched once for every batch of
   every ladder width; then long-bag training (``--max_contexts 0``) on its
   ``--longbag-ab`` lengths (10,240 methods, mean 60, sigma 1.2, max 3,200;
   batch 256, rungs above 200 from ``derive_longbag_ladder``) on plain,
   fused (K3 at the base rungs, masked K4 online above) and fused two_pass
   (masked K4 two_pass at every width): no context truncated, the peak
   device memory of each run; a differential at three widths (the narrowest
   rung, 200, the widest long rung) of every kernel route against plain,
   dropout 0; and the long-bag fused dir served by ``build_server``, a
   2,000-context request answered through K4;
9. train_bf16 — the train phase's corpus, widths, batch, bag and dropout
   with ``--compute_dtype bfloat16 --adam_mu_dtype bfloat16``, 2 epochs on
   plain, pool_only (K1 + K1b over bf16 contexts), gather_split (K2 over
   bf16 rows, with the keep mask) and fused (K3, f32 rows as before): losses
   finite, each route's F1 > 0, the bf16 kernels launched once for every
   train batch; steps/s, real contexts/s, F1 and peak memory beside the f32
   train phase's; a dropout-0 differential of the routes' gradients from
   one set of weights at widths 25 and 200 (losses within rtol 2^-7,
   gradients within 2^-5 of each tensor's largest element: bf16 rounds
   apart on each route); the step breakdown; and the fused run's
   checkpoint (bf16 first moments) restored, and refused under float32.
   The kernels phase holds K1 / K1b over bf16 contexts (d_ctx within 1e-5
   plus one bf16 ulp) and K2 over bf16 rows (masked and not, and against the f32 K2
   fed the same rows widened: two TF32 products against three) against
   their plain versions;
10. train_lazy — the train phase's corpus, widths, batch, bag and dropout
   with ``--table_update lazy`` (the tables' touched rows only, from per-slot
   gradients), 2 epochs on plain, pool_only (K1 + K1b), gather_split
   (masked K2) and fused (masked K3), and with bf16 compute + bf16 first
   moments on plain and fused: each kernel launched once for every train
   batch, F1 > 0, loss, F1, steps/s, real contexts/s and peak memory beside
   the dense runs of the train and train_bf16 phases; a dropout-0
   differential of 3 lazy steps a route against the lazy plain route (the
   train differential's tolerances on the losses, the other parameters'
   gradients and the tables' per-slot gradients; every row a step leaves
   untouched, and its moments, bit for bit unchanged); per route, a warm
   step's table optimizer run under ``torch.cuda.set_sync_debug_mode(
   "error")`` (it must not sync; the whole step is tried the same way and
   where it syncs is printed), and the profiler's op list of a lazy step
   (no embedding backward, no ``[V, E]``-sized zero / ``index_put`` /
   ``index_add_``, the tables' ``.grad`` None; the dense plain step must show
   its embedding backward); the step breakdown with the mean rows a step
   touches per table (f32 every route, bf16 plain and fused), beside the
   dense breakdowns; and one lazy epoch of the long-bag recipe on fused
   (masked K3 at the base rungs, masked K4 online above, once a batch);
11. train_device — the train phase's corpus, widths, batch, bag and dropout
   with ``--device_epoch`` (both splits staged on the card, each epoch's
   batches sampled there, 16 steps a chunk), 2 epochs on plain, pool_only
   (K1 + K1b), gather_split (masked K2 in training, K2 in eval) and fused
   (masked K3, K3), on fused with ``--table_update lazy`` in bf16 (compute
   and first moments), and with ``--sample_prefetch`` on plain and fused
   (losses within rtol 1e-4 of the unprefetched runs'); bucketed device
   epochs on the train_bucketed phase's corpus and ladder on plain and
   fused. Each kernel launched once for every train and eval batch, losses
   finite, F1 > 0; per epoch epoch_seconds, steps/s and real contexts/s
   beside the host-fed run of the same recipe, the staging's seconds and
   bytes, and the peak device memory. Per route, dropout 0: one chunk of
   the runner against the host step fed the same sampled batches (losses
   within rtol 1e-5), and the next chunk, warm, under
   ``torch.cuda.set_sync_debug_mode("error")``: a sync fails the phase and
   is printed with where it happened; last, where a warm plain device
   epoch's time goes (the train pass's enqueue and read, the eval pass,
   the F1 on the host, the device's busy time over a train pass);
11b. train_feed (after train_device) — the host feed on ``bench.py``'s
   training generator at 16,384 methods (mean 120 contexts, max 400, seed
   0; the train phase's widths, batch 1024, bag 200, dropout 0.25, 2
   epochs, ``--profile_steps 8``): the corpus written as ``corpus.txt``,
   converted to a CSR container by the port's ``tools/corpus_convert.py``
   (its seconds and bytes), parsed natively (beside the Python parser on a
   4,096-method slice), loaded through the native parser (a fallback
   fails the phase) and then the cache (its seconds), VmRSS before and
   after a host epoch of the mmap source; then ``train()`` on fused
   synchronously, with ``--prefetch_batches 2``, with ``--feed_workers W``
   (W = min(4, usable cores - 1)), with both, from the container fixed and
   bucketed (synchronously and with both), streamed
   (``--stream_chunk_items 8192``, synchronously and with prefetch), and
   on pool_only (synchronously and with both). After each timed run an
   untimed pass draws the stream it was fed through the same feed and
   hashes every host batch as it is copied: each run's digests equal its
   synchronous stream's and its losses are within rtol 1e-5; each kernel
   launched once for every train and eval batch. Per run epoch_seconds, steps/s, real contexts/s,
   the profiled host-build / H2D / feed-wait / compute split and the peak
   device memory, beside the train_device phase's fused device epochs;
12. extract — the port's extractor (built in the build phase: its
   seconds), the share of a method's contexts each ``@var_*`` alias of
   ``examples/java/src`` touches, ``examples/java`` extracted into a
   dataset, a method-task and a variable-task model trained on it on the
   card (fused, 10 epochs), ``predict_source`` / ``predict_variables`` of
   ``MathUtils.java`` through K3 against the plain versions on the CPU (the
   names, counts and top-1, code vectors within rtol 2e-4 / atol 2e-5),
   and the method model served: every method of the examples as a
   ``source`` request and as a ``contexts`` request of its mapped ids, for
   predict, embed and neighbors, one at a time, 3 rounds; the answers equal
   (code vectors within 1e-6), p50/p99 of each form with the extraction's
   ms apart, by file with the files' bytes and the methods' contexts,
   beside the serve phase's top11 one-at-a-time p50 (fused f32), and the
   server warmup's load of the extractor;
13. train_variable — the variable-name task (``--infer_variable_name``,
   ``--shuffle_variable_indexes``) on the train phase's corpus with 0-3
   ``@var_*`` aliases a method, each alias at the start or end of the share
   the extract phase measured (15% if that is below 10%) of its method's
   contexts, at the train phase's widths, batch, bag and dropout, 2 epochs:
   host-fed and device epochs, each at a fixed bag and bucketed (the ladder
   derived from the methods' counts, as JAX derives it), on every route; the
   dual task on fused, host-fed and on the device; fused device epochs lazy
   in bf16. Per run epoch_seconds, steps/s, real contexts/s, pad_efficiency,
   loss, F1 and the launches, each kernel once for every batch of the
   passes that run it, the train loss lower after the last epoch than after
   the first; the variable rows and their mean real contexts; the step
   breakdown on variable batches (plain, fused); a dropout-0
   differential on a batch with an all-PAD row and 255 one-context rows
   (the train differential's tolerances); per route a device chunk (the
   remap on) against the host step and a warm chunk under
   ``torch.cuda.set_sync_debug_mode("error")``;
14. python_source (run after extract, before train_variable) — (a) a mixed
   Java + Python dataset extracted by the port's extractor CLI with the
   repo root as the source dir: the rows of ``examples/java`` and
   ``examples/python`` and one ``<file>\t*`` row for each
   ``code2vec_tpu/**/*.py`` (the frozen JAX package, read as text and never
   imported): its functions, labels, contexts, vocab counts,
   ``truncated_context_fraction`` at bag 200, the extraction's seconds and
   each Python file's extraction ms by its size; (b) a method model at
   top11's widths (embed 100/100, encode 100, bag 200, dropout 0.25; the
   corpus's own vocab and labels; batch 64) trained 5 epochs on fused
   (masked K3) and on pool_only (K1 + K1b): steps/s, loss, F1, each kernel
   once a batch; (c) ``examples/python/src/util/math_utils.py`` predicted
   and embedded as a file through K3 against the plain versions on the CPU;
   (d) a server with the long-bag rungs 512/1024/2048: every Python function
   as a ``source`` request (``language: "python"``) for predict and embed,
   and every Python file as ``embed_file``, one at a time: p50/p99 of each,
   ``extract_ms`` by file size, the launches (K3, and K4 for the functions
   at the long-bag rungs; longer ones subsampled as the engine does), each
   embedding against the model run plain on the card; (e) ``code.vec`` of
   those embeddings, ``file.vec`` from ``export_file_vectors`` (each row
   equal to the served ``embed_file`` vector), its IVF-PQ index from the
   port's ``tools/ann_build.py``, and every file's ``neighbors`` at
   ``granularity="file"``: on the exact backend the file itself first
   (similarity within 1e-4 of 1), on ``--retrieval_backend ann`` in the top
   5, K5 launched for every request;
15. a line with the launch floor and the ``neighbors`` split, the card's
   name and power limit, the line ``{"kernels": [...]}`` (per kernel:
   route, source, the TPU kernel it replaces, launches on its serve or
   train route (the masked K4's on the long-bag runs) plus those of the
   train_device phase's runs of the four routes, of the train_feed runs,
   of every train_variable run, of the python_source phase, of the
   serve_control phase, of the train_elastic runs, of the train_hpo
   trials (K1/K1b: the kernel events of its CLI run's profiled epoch), of
   both ranks of the train_mesh runs (K5: of its serving pair) and of the
   autotune phase's search,
   auto training, engines and searcher, max error,
   times at the headline shape and the bound), then, last, the result
   line.

With ``--json_out`` the per-shape kernel records and serving numbers are
also written to that file. ``--phases a,b`` runs only those phases after
device and build and prints no result line (for work on one phase).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

TOP11 = dict(terminal_count=360_633, path_count=342_846, label_count=8_000,
             terminal_embed_size=100, path_embed_size=100, encode_size=100)
BAG, LADDER, BATCH_SIZES = 200, (25, 50, 100, 200), (1, 8, 64)
SHAPES = [(b, l) for b in (1, 8, 64) for l in (1, 37, 200)]
TIMED_SHAPE = (64, 200)
# training: batch 1024 at bag 200 (the top11 recipe); K1b at these shapes,
# the masked K2/K3 at SHAPES plus the training shape
TRAIN_BATCH, TRAIN_SHAPE = 1024, (1024, 200)
BWD_SHAPES = [(b, l) for b in (1, 64, 1024) for l in (1, 37, 200)]
MASKED_SHAPES = SHAPES + [TRAIN_SHAPE]
KEEP = 0.75  # 1 - dropout 0.25
LONG_SHAPES = [(b, l) for b in (1, 8, 64) for l in (512, 1024, 2048)]
LONG_TIMED_SHAPE = (64, 2048)
# long-bag training: batch 256, rungs up to 4096 (bench.py's --longbag-ab);
# the masked K4 at these shapes, timed at the top rung
LONGBAG_BATCH = 256
LONGBAG_TRAIN_SHAPE = (LONGBAG_BATCH, 4096)
MASKED_LONG_SHAPES = ([(b, l) for b in (1, 8, 64) for l in (1, 37, 200, 513, 2048)]
                      + [LONGBAG_TRAIN_SHAPE])
LONGBAG_RUNGS = (512, 1024, 2048)
K4_MODES = ("online", "two_pass")
# the retrieval corpus (bench.py's ANN corpus at the served encode width)
ANN_N, ANN_DIM, ANN_CLUSTERS, ANN_NOISE = 1_000_000, 100, 8192, 0.12
ANN_NLIST, ANN_M, ANN_SHORTLIST, ANN_PROBE = 1000, 20, 256, 16
ANN_QUERIES, ANN_CONTEXT_QUERIES = 64, 16
K5_SHAPES = [(q, p) for q in (1, 8, 64) for p in (8, 16)]
K5_TIMED_SHAPE = (1, ANN_PROBE)  # a neighbors query: one at a time
TOL = 1e-5  # kernel vs plain version (f32 plain, 3xTF32 encode on the tensor cores)
SERVE_RTOL, SERVE_ATOL = 2e-4, 2e-5
N_TIMED = 30
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth, f32
# on the FMA pipes, TF32 on the tensor cores (dense). The least the encode
# of K2-K4 needs on the tensor cores is TF32_PRODUCTS[table dtype] products
# for f32 accuracy: three for f32 rows (hi*hi + hi*lo + lo*hi); two for bf16
# rows, which are exact in TF32 (lo = 0), and for int8 rows, whose codes are
# exact in TF32 with the row scale applied after each segment's product.
# Everything else runs on the FMA pipes.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TF32_PRODUCTS = {"f32": 3, "bf16": 2, "int8": 2}
# the encode kernels' row sources: K2's f32 and bf16 gathered rows, K3/K4's
# f32, bf16 and int8 tables
ROW_SOURCES = 5
# bf16 training: K1/K1b over bf16 contexts at the K1 shapes plus the
# training shape; K2 over bf16 rows at the K2 shapes, masked at the training
# shape; the differential's widths
BF16_POOL_SHAPES = SHAPES + [TRAIN_SHAPE]
BF16_DIFF_WIDTHS = (25, BAG)
ENCODE_KERNELS = ("encode_pool_online_kernel", "encode_score_kernel",
                  "encode_pool_fixed_max_kernel")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sass_check(build, lib_path) -> dict:
    """TF32 HMMA instructions per encode kernel in the library's SASS
    (``cuobjdump`` beside the ``nvcc`` that built it); raises if one of the
    three encode kernels, for any of the ROW_SOURCES row sources, has none."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line and "TF32" in line:
            counts[fn] += 1
    encode = {fn: n for fn, n in counts.items() if any(k in fn for k in ENCODE_KERNELS)}
    for fn, n in sorted(encode.items()):
        print(f"  sass: {n:4d} TF32 HMMA in {fn}")
    kinds = {k: [n for fn, n in encode.items() if k in fn] for k in ENCODE_KERNELS}
    missing = [k for k, ns in kinds.items() if len(ns) != ROW_SOURCES or min(ns) == 0]
    if missing:
        raise AssertionError(f"encode kernels without TF32 HMMA (or not one per row source): "
                             f"{missing}; counts {encode}")
    print("  sass: every encode kernel runs on the tensor cores (K3's materialize launches "
          "encode_pool_online_kernel)", flush=True)
    return encode


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


class KernelBench:
    def __init__(self, torch, dev):
        self.torch = torch
        self.dev = dev
        self.flush_buf = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
        self.spread = (0.0, 0.0)

    def time_ms(self, fn) -> float:
        """Median device milliseconds of one call over N_TIMED launches,
        each with a cold L2 (a 96 MB write before it, outside the timed
        events). The card is held busy (``torch.cuda._sleep``) while the
        host enqueues the call, so host launch overhead is not timed. The
        fastest and slowest launch stay in ``self.spread``."""
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(N_TIMED):
            self.flush_buf.zero_()
            torch.cuda._sleep(4_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        self.spread = (min(times), max(times))
        return float(np.median(times))


def bag_keep(torch, dev, g, B, L):
    """[B, L] real-context mask: the first row a full bag of L, the others
    uniform in 1..L with PAD tails, and the last row all-PAD when B > 1."""
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lens[0] = L
    if B > 1:
        lens[-1] = 0
    return torch.arange(L, device=dev)[None, :] < lens[:, None]


def pool_inputs(torch, dev, g, B, L, H):
    ctx = torch.tanh(torch.randn(B, L, H, generator=g, device=dev))
    mask = bag_keep(torch, dev, g, B, L).float()
    attn = 0.08 * torch.randn(H, generator=g, device=dev)
    return ctx, mask, attn


def id_inputs(torch, dev, g, B, L):
    c = TOP11
    s = torch.randint(1, c["terminal_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    p = torch.randint(1, c["path_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    e = torch.randint(1, c["terminal_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    keep = bag_keep(torch, dev, g, B, L)
    s, p, e = (x * keep for x in (s, p, e))
    return s, p, e, (s > 0).float()


def pool_bound(B, L, H, ctx_item=4):
    """K1: ctx read once (``ctx_item`` bytes an element: 4 f32, 2 bf16),
    mask, a, cv and w; 4 flops an element."""
    nbytes = ctx_item * B * L * H + 4 * (2 * B * L + H + B * H)
    flops = 4 * B * L * H
    return nbytes, flops


def pool_bwd_bound(B, L, H, ctx_item=4):
    """K1b: read ctx once and write d_ctx once (``ctx_item`` bytes an
    element each), plus w, mask, g_w, cv, g_cv, a and d_attn; 2 flops an
    element for dldw, 3 for d_ctx, 2 for d_attn."""
    nbytes = 2 * ctx_item * B * L * H + 4 * (3 * B * L + 2 * B * H + 2 * H)
    flops = 7 * B * L * H
    return nbytes, flops


def bf16_ulp(torch, x):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    mag = x.abs().double().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def encode_pool_bound(torch, s, p, e, mask, table_dtype, H):
    """Bytes of the rows these ids need (each distinct row once) plus ids,
    mask, weights and outputs; flops of encode + LayerNorm/tanh/pool for
    the contexts the function needs: each real one, plus one encode per
    all-PAD row (its uniform weights average one repeated row); a PAD slot
    of a row with real contexts has weight exactly 0 and needs none.
    Returns (bytes, flops, seconds of operations): the encode's 2*D*H per
    context TF32_PRODUCTS[table_dtype] times at the TF32 tensor-core rate,
    the 8*H of LayerNorm/tanh/pool at the f32 rate."""
    c = TOP11
    B, L = s.shape
    et, ep = c["terminal_embed_size"], c["path_embed_size"]
    d = 2 * et + ep
    item = {"f32": 4, "bf16": 2, "int8": 1}[table_dtype]
    scale = 4 if table_dtype == "int8" else 0
    t_rows = torch.unique(torch.cat([s.flatten(), e.flatten()])).numel()
    p_rows = torch.unique(p.flatten()).numel()
    nbytes = (t_rows * (et * item + scale) + p_rows * (ep * item + scale)
              + 4 * (4 * B * L + d * H + 3 * H + B * H + B * L))
    real = int(mask.sum().item()) + int((mask.sum(dim=1) == 0).sum().item())
    ops_s = (TF32_PRODUCTS[table_dtype] * 2 * d * H * real / TF32_FLOP_PER_S
             + 8 * H * real / F32_FLOP_PER_S)
    return nbytes, (2 * d * H + 8 * H) * real, ops_s


def bound_of(nbytes, ops_s):
    """The larger of the bytes' time at the HBM rate and the operations'
    time, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= ops_s else (ops_s, "operations")


def phase_kernels(torch, dev, smi) -> dict:
    import torch.nn.functional as F

    from code2vec_tpu_torch.ops.attention import NINF, attention_pool, pool_backward_reference
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        gather_rows,
        reference_forward,
        split_reference_forward,
        streamed_reference_forward,
    )
    from code2vec_tpu_torch.ops.pool_kernel import (
        attention_pool_kernel,
        pool_backward_kernel,
        pool_bwd_grid,
        pool_ctas,
    )
    from code2vec_tpu_torch.ops.quant import quantize_table

    c = TOP11
    H, D = c["encode_size"], 2 * c["terminal_embed_size"] + c["path_embed_size"]
    g = torch.Generator(device=dev).manual_seed(1234)
    bench = KernelBench(torch, dev)
    t_f32 = torch.randn(c["terminal_count"], c["terminal_embed_size"], generator=g, device=dev)
    p_f32 = torch.randn(c["path_count"], c["path_embed_size"], generator=g, device=dev)
    tables = {"f32": (t_f32, p_f32)}
    for dt in ("bf16", "int8"):
        tables[dt] = (quantize_table(t_f32, dt), quantize_table(p_f32, dt))
    bf16 = torch.bfloat16
    # the f32 tables' values rounded to bf16, widened: the f32 K2 reads the
    # same rows K2 over bf16 rows reads
    widened = tuple(x.to(bf16).float() for x in (t_f32, p_f32))
    W = torch.randn(D, H, generator=g, device=dev) / math.sqrt(D)
    lns = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    lnb = 0.1 * torch.randn(H, generator=g, device=dev)
    attn = 0.08 * torch.randn(H, generator=g, device=dev)

    specs = [  # (name, launch key, source, replaces, impl, table dtype, softmax, shapes)
        ("K1 pool", "pool", "code2vec_tpu_torch/csrc/pool.cu",
         "code2vec_tpu/ops/pallas_attention.py:114", None, None, None, SHAPES),
        ("K1b pool backward", "pool_bwd", "code2vec_tpu_torch/csrc/pool.cu",
         "code2vec_tpu/ops/pallas_attention.py:224", "pool_bwd", None, None, BWD_SHAPES),
        ("K2 encode_pool gather_split", "gather_split",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "gather_split", "f32", "materialize",
         SHAPES),
        ("K2 encode_pool gather_split masked", "gather_split_masked",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "gather_split", "f32", "masked",
         MASKED_SHAPES),
        ("K3 encode_pool fused f32 masked", "fused_f32_masked",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "fused", "f32", "masked", MASKED_SHAPES),
        ("K1 pool bf16", "pool_bf16", "code2vec_tpu_torch/csrc/pool.cu",
         "code2vec_tpu/ops/pallas_attention.py:114", "pool_bf16", None, None, BF16_POOL_SHAPES),
        ("K1b pool backward bf16", "pool_bwd_bf16", "code2vec_tpu_torch/csrc/pool.cu",
         "code2vec_tpu/ops/pallas_attention.py:224", "pool_bwd_bf16", None, None,
         BF16_POOL_SHAPES),
        ("K2 encode_pool gather_split bf16", "gather_split_bf16",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "gather_split_bf16", "bf16", "materialize",
         SHAPES),
        ("K2 encode_pool gather_split bf16 masked", "gather_split_bf16_masked",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "gather_split_bf16", "bf16", "masked",
         [TRAIN_SHAPE]),
    ] + [
        (f"K3 encode_pool fused {dt}", f"fused_{dt}",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "fused", dt, "materialize", SHAPES)
        for dt in ("f32", "bf16", "int8")
    ] + [
        (f"K4 encode_pool {mode} {dt}", f"{mode}_{dt}",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "fused", dt, mode, LONG_SHAPES)
        for mode in K4_MODES for dt in ("f32", "bf16", "int8")
    ] + [
        (f"K4 encode_pool {mode} f32 masked", f"{mode}_f32_masked",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "fused", "f32", f"{mode}_masked",
         MASKED_LONG_SHAPES)
        for mode in K4_MODES
    ]
    one = torch.ones(1, device=dev)
    floor_ms = bench.time_ms(lambda: one + one)
    floor = {"ms": floor_ms, "ms_min_max": list(bench.spread)}
    print(f"launch floor (one-element add, timed as every kernel below): ms={floor_ms:.4f} "
          f"(launches {bench.spread[0]:.4f}-{bench.spread[1]:.4f})", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = {}
    for name, key, source, replaces, impl, dt, mode, shapes in specs:
        rows = []
        for B, L in shapes:
            library = unmasked = None
            extra = {}
            if impl == "pool_bf16":
                ctx, mask, a = pool_inputs(torch, dev, g, B, L, H)
                ctx, a = ctx.to(bf16), a.to(bf16)
                kernel = lambda: attention_pool_kernel(ctx, mask, a)  # noqa: E731
                plain = lambda: attention_pool(ctx.float(), mask, a.float())  # noqa: E731
                wide, a_wide = ctx.float(), a.float()
                add_mask = ((1.0 - mask) * NINF)[:, None, :]

                def library():
                    return F.scaled_dot_product_attention(
                        a_wide.expand(B, 1, H), wide, wide, attn_mask=add_mask, scale=1.0)

                # the f32 kernel on the same values widened, timed beside it
                extra["f32_kernel_ms"] = bench.time_ms(
                    lambda: attention_pool_kernel(wide, mask, a_wide))
                nbytes, flops = pool_bound(B, L, H, ctx_item=2)
                ops_s = flops / F32_FLOP_PER_S
            elif impl == "pool_bwd_bf16":
                ctx, mask, a = pool_inputs(torch, dev, g, B, L, H)
                ctx, a = ctx.to(bf16), a.to(bf16)
                # w and cv of one pool over the bf16 contexts, as K1 gives them
                cv0, w0 = attention_pool(ctx.float(), mask, a.float())
                g_cv = torch.randn(B, H, generator=g, device=dev)
                g_w = torch.randn(B, L, generator=g, device=dev)
                bargs = (ctx, mask, a, w0, g_cv, g_w)
                kernel = lambda: pool_backward_kernel(*bargs[:4], cv0, *bargs[4:])  # noqa: E731
                plain = lambda: pool_backward_reference(*bargs)  # noqa: E731
                wide_args = (ctx.float(), mask, a.float(), w0, cv0, g_cv, g_w)
                extra["f32_kernel_ms"] = bench.time_ms(lambda: pool_backward_kernel(*wide_args))
                leaves = (ctx.float().requires_grad_(), a.float().requires_grad_())
                pooled = attention_pool(leaves[0], mask, leaves[1])

                def library():
                    return torch.autograd.grad(pooled, leaves, (g_cv, g_w), retain_graph=True)

                nbytes, flops = pool_bwd_bound(B, L, H, ctx_item=2)
                ops_s = flops / F32_FLOP_PER_S
            elif impl == "gather_split_bf16":
                # K2 over bf16 rows (the rows gathered in bf16 by the wrapper)
                s, p, e, mask = id_inputs(torch, dev, g, B, L)
                drop = None
                if mode == "masked":
                    drop = torch.empty(B, L, H, device=dev).bernoulli_(KEEP, generator=g) / KEEP
                bargs = (t_f32, p_f32, s, p, e, mask, W, lns, lnb, attn, drop)
                kernel = lambda: fused_encode_attend_pool(  # noqa: E731
                    *bargs, impl="gather_split", compute_dtype=bf16)
                plain = lambda: split_reference_forward(*bargs, compute_dtype=bf16)  # noqa: E731
                if drop is not None:
                    unmasked = lambda: fused_encode_attend_pool(  # noqa: E731
                        *bargs[:-1], impl="gather_split", compute_dtype=bf16)
                # two TF32 products against the f32 K2's three on the same rows
                two = kernel()
                three = fused_encode_attend_pool(*widened, *bargs[2:], impl="gather_split")
                torch.cuda.synchronize()
                extra["bitwise_vs_three_products"] = float(
                    all(torch.equal(x, y) for x, y in zip(two, three)))
                extra["max_abs_diff_vs_three_products"] = max(
                    (x - y).abs().max().item() for x, y in zip(two, three))
                extra["f32_kernel_ms"] = bench.time_ms(lambda: fused_encode_attend_pool(
                    *widened, *bargs[2:], impl="gather_split"))
                # the wrapper's PyTorch gather (and cast) before the kernel, in
                # each timed call: bf16 rows and f32 rows
                extra["gather_ms"] = bench.time_ms(lambda: [gather_rows(
                    t_f32 if i != 1 else p_f32, x, bf16) for i, x in enumerate((s, p, e))])
                extra["f32_gather_ms"] = bench.time_ms(lambda: [gather_rows(
                    t_f32 if i != 1 else p_f32, x) for i, x in enumerate((s, p, e))])
                nbytes, flops, ops_s = encode_pool_bound(torch, s, p, e, mask, "bf16", H)
                if drop is not None:
                    nbytes += 4 * B * L * H  # the keep mask, read once
            elif impl == "pool_bwd":
                ctx, mask, a = pool_inputs(torch, dev, g, B, L, H)
                cv0, w0 = attention_pool(ctx, mask, a)
                g_cv = torch.randn(B, H, generator=g, device=dev)
                g_w = torch.randn(B, L, generator=g, device=dev)
                bargs = (ctx, mask, a, w0, g_cv, g_w)
                kernel = lambda: pool_backward_kernel(*bargs[:4], cv0, *bargs[4:])  # noqa: E731
                plain = lambda: pool_backward_reference(*bargs)  # noqa: E731
                leaves = (ctx.clone().requires_grad_(), a.clone().requires_grad_())
                pooled = attention_pool(leaves[0], mask, leaves[1])

                def library():
                    return torch.autograd.grad(pooled, leaves, (g_cv, g_w), retain_graph=True)

                nbytes, flops = pool_bwd_bound(B, L, H)
                ops_s = flops / F32_FLOP_PER_S
            elif mode is not None and mode.endswith("masked"):
                # K2/K3 ("masked") or K4 ("<online|two_pass>_masked") with the keep mask
                softmax = mode[:-len("_masked")] if mode != "masked" else "materialize"
                s, p, e, mask = id_inputs(torch, dev, g, B, L)
                drop = torch.empty(B, L, H, device=dev).bernoulli_(KEEP, generator=g) / KEEP
                margs = (*tables[dt], s, p, e, mask, W, lns, lnb, attn)
                kernel = lambda: fused_encode_attend_pool(  # noqa: E731
                    *margs, drop, impl=impl, softmax_mode=softmax)
                if softmax == "materialize":
                    plain = lambda: reference_forward(*margs, drop)  # noqa: E731
                else:
                    plain = lambda: streamed_reference_forward(  # noqa: E731
                        *margs, drop, softmax_mode=softmax)
                unmasked = lambda: fused_encode_attend_pool(  # noqa: E731
                    *margs, impl=impl, softmax_mode=softmax)
                nbytes, flops, ops_s = encode_pool_bound(torch, s, p, e, mask, dt, H)
                if softmax == "two_pass":
                    # the kernel's own work by design: every context encoded in
                    # both passes and the keep mask read in both
                    extra["bound_both_passes_ms"] = bound_of(
                        nbytes + 8 * B * L * H, 2 * ops_s)[0] * 1e3
                nbytes += 4 * B * L * H  # the keep mask, read once
            elif impl is None:
                ctx, mask, a = pool_inputs(torch, dev, g, B, L, H)
                kernel = lambda: attention_pool_kernel(ctx, mask, a)  # noqa: E731
                plain = lambda: attention_pool(ctx, mask, a)  # noqa: E731
                add_mask = ((1.0 - mask) * NINF)[:, None, :]

                def library():
                    return F.scaled_dot_product_attention(
                        a.expand(B, 1, H), ctx, ctx, attn_mask=add_mask, scale=1.0
                    )

                nbytes, flops = pool_bound(B, L, H)
                ops_s = flops / F32_FLOP_PER_S
            else:
                s, p, e, mask = id_inputs(torch, dev, g, B, L)
                T, P = tables[dt]
                args = (T, P, s, p, e, mask, W, lns, lnb, attn)
                kernel = lambda: fused_encode_attend_pool(  # noqa: E731
                    *args, impl=impl, softmax_mode=mode)
                if mode == "materialize":
                    plain = lambda: reference_forward(*args)  # noqa: E731
                else:
                    plain = lambda: streamed_reference_forward(  # noqa: E731
                        *args, softmax_mode=mode)
                nbytes, flops, ops_s = encode_pool_bound(torch, s, p, e, mask, dt, H)
            cv, w = kernel()
            cv_ref, w_ref = plain()
            torch.cuda.synchronize()
            if not (torch.isfinite(cv).all() and torch.isfinite(w).all()):
                raise AssertionError(f"{name} at {(B, L)}: non-finite output")
            err = max((cv.float() - cv_ref.float()).abs().max().item(),
                      (w - w_ref).abs().max().item())
            if impl == "pool_bwd_bf16":
                # d_ctx within the f32 K1b's 1e-5 plus one bf16 ulp (each side
                # rounds its f32 value once), d_attn within rtol 1e-4
                over = ((cv.double() - cv_ref.double()).abs() - TOL) / bf16_ulp(torch, cv_ref)
                if over.max() > 1.0:
                    raise AssertionError(f"{name} at {(B, L)}: d_ctx {over.max():.2f} bf16 ulp "
                                         f"past {TOL}")
                torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=TOL)
            elif impl == "pool_bwd":  # d_ctx within 1e-5, d_attn within rtol 1e-4
                torch.testing.assert_close(cv, cv_ref, rtol=0, atol=TOL)
                torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=TOL)
            elif mode in ("materialize", "masked") or impl in (None, "pool_bf16"):  # K4: max|err|
                torch.testing.assert_close(cv, cv_ref, rtol=TOL, atol=TOL)
                torch.testing.assert_close(w, w_ref, rtol=TOL, atol=TOL)
            elif err > TOL:
                raise AssertionError(f"{name} at {(B, L)}: max |err| {err:.3e} > {TOL}")
            bound_s, bound_by = bound_of(nbytes, ops_s)
            ms = bench.time_ms(kernel)
            lo, hi = bench.spread
            row = {
                "B": B, "L": L, "max_abs_err": err,
                "ms": ms, "ms_min_max": [lo, hi], "plain_ms": bench.time_ms(plain),
                "library_ms": bench.time_ms(library) if library else None,
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "bytes": nbytes, "flops": flops,
            }
            if unmasked is not None:
                row["unmasked_ms"] = bench.time_ms(unmasked)
            row.update(extra)
            if impl in (None, "pool_bf16"):
                row["ctas_per_row"] = pool_ctas(B, L, sms)
            elif impl in ("pool_bwd", "pool_bwd_bf16"):
                row["ctas"] = pool_bwd_grid(
                    B, L, H, bf16 if impl == "pool_bwd_bf16" else torch.float32, dev)[0]
            rows.append(row)
            print(f"kernel {name:32s} B={B:3d} L={L:4d} max_abs_err={err:.3e} "
                  f"ms={ms:.4f} (launches {lo:.4f}-{hi:.4f}) "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
                  f"({bound_by}) bound_share={row['bound_ms'] / ms:.3f}"
                  + (f" unmasked_ms={row['unmasked_ms']:.4f}" if unmasked else "")
                  + "".join(f" {k}={v:.4f}" for k, v in extra.items())
                  + f" [{smi}]", flush=True)
        timed = {id(LONG_SHAPES): LONG_TIMED_SHAPE, id(BWD_SHAPES): TRAIN_SHAPE,
                 id(MASKED_SHAPES): TRAIN_SHAPE, id(BF16_POOL_SHAPES): TRAIN_SHAPE,
                 id(MASKED_LONG_SHAPES): LONGBAG_TRAIN_SHAPE}.get(id(shapes), TIMED_SHAPE)
        if shapes == [TRAIN_SHAPE]:
            timed = TRAIN_SHAPE
        records[name] = dict(key=key, source=source, replaces=replaces, rows=rows,
                             timed=timed)
    print("kernels checked: " + ", ".join(f"{n}: ok" for n in records), flush=True)
    return records, floor


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


def write_model_dir(torch, path: Path, device, seed: int = 0, vocab: bool = True,
                    nan_w: bool = False) -> None:
    """A top11-width model dir with random weights from ``seed``; without
    ``vocab`` the terminal and path files are left out (a server takes
    them from its own flags), with ``nan_w`` W holds a NaN."""
    from code2vec_tpu_torch import interop
    from code2vec_tpu_torch.formats.vocab_io import write_vocab
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig

    c = TOP11
    cfg = Code2VecConfig(**c)
    with torch.device(device):
        model = Code2Vec(cfg)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    if nan_w:
        with torch.no_grad():
            model.input_linear.weight[0, 0] = float("nan")
    path.mkdir(parents=True, exist_ok=True)
    interop.save_state_dict(model.state_dict(), str(path), cfg)
    meta = dict(c, angular_margin_loss=False, angular_margin=0.5, inverse_temp=30.0,
                vocab_pad_multiple=1, max_path_length=BAG, infer_method_name=True,
                infer_variable_name=False, table_dtype="f32", bucket_ladder=list(LADDER))
    (path / "model_meta.json").write_text(json.dumps(meta))
    write_vocab(path / "label_vocab.txt", ((i, f"label{i}") for i in range(c["label_count"])))
    if not vocab:
        return
    # "@question" takes terminal index 1, so the file holds count-1 names
    write_vocab(path / "terminal_idxs.txt",
                ((i, f"t{i}" if i else "<PAD/>") for i in range(c["terminal_count"] - 1)))
    write_vocab(path / "path_idxs.txt",
                ((i, f"p{i}" if i else "<PAD/>") for i in range(c["path_count"])))


def make_requests(n_requests: int, seed: int, lengths=None) -> list[dict]:
    c = TOP11
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = np.clip(rng.lognormal(np.log(60), 1.0, n_requests).astype(int), 1, 400)
        lengths[:4] = (1, 200, 201, 400)
    reqs = []
    for i, n in enumerate(lengths):
        ctx = np.stack([
            rng.integers(1, c["terminal_count"], n),
            rng.integers(1, c["path_count"], n),
            rng.integers(0, c["terminal_count"], n),
        ], axis=1)
        reqs.append({"id": i, "op": "predict" if i % 2 == 0 else "embed",
                     "contexts": ctx.tolist(), "top_k": 5, "include_vector": True})
    return reqs


def longbag_lengths(n_requests: int, seed: int) -> np.ndarray:
    """Three quarters of the bags 1-200 contexts, one quarter 201-2048,
    both log-uniform, shuffled; the first long one is exactly 2048."""
    rng = np.random.default_rng(seed)
    n_long = n_requests // 4
    short = np.exp(rng.uniform(0, np.log(BAG), n_requests - n_long)).astype(int)
    long = np.exp(rng.uniform(np.log(BAG + 1), np.log(LONGBAG_RUNGS[-1]), n_long)).astype(int)
    long[0] = LONGBAG_RUNGS[-1]
    lengths = np.clip(np.concatenate([short, long]), 1, LONGBAG_RUNGS[-1])
    # the 2048 bag is served one at a time and pipelined (the second copy)
    order = rng.permutation(n_requests)
    lengths = lengths[order]
    lengths[np.flatnonzero(lengths == LONGBAG_RUNGS[-1])[0]] = BAG + 7
    lengths[0], lengths[-1] = LONGBAG_RUNGS[-1], LONGBAG_RUNGS[-1]
    return lengths


def serve_route(torch, model_dir: Path, impl: str, table_dtype: str, requests, smi,
                device, *, extra=(), ladder=LADDER, rtol=SERVE_RTOL, atol=SERVE_ATOL) -> dict:
    from code2vec_tpu_torch.data.pipeline import nearest_bucket_width
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.predict import softmax_top_k, subsample
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    args = build_parser().parse_args([
        "--model_path", str(model_dir),
        "--terminal_idx_path", str(model_dir / "terminal_idxs.txt"),
        "--path_idx_path", str(model_dir / "path_idxs.txt"),
        "--table_dtype", table_dtype, "--pallas_impl", impl,
        "--batch_sizes", ",".join(map(str, BATCH_SIZES)), "--deadline_ms", "2",
        "--device", str(device), *extra,
    ])
    max_width = ladder[-1]
    label = f"{impl}/{table_dtype}" + (f" {' '.join(extra)}" if extra else "")
    reset_launch_counts()
    t0 = time.perf_counter()
    server = build_server(args)
    startup_s = time.perf_counter() - t0
    n_seq = len(requests) // 3
    latencies, responses = [], []
    try:
        for req in requests[:n_seq]:
            t = time.perf_counter()
            responses.append(server.handle(req))
            latencies.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        resolvers = [server.handle_async(req) for req in requests[n_seq:]]
        responses += [r() for r in resolvers]
        pipelined_s = time.perf_counter() - t
        health = server.handle({"op": "health"})
    finally:
        server.close()
    counts = launch_counts()

    # the same model without kernels, on the card, at full f32 precision
    predictor = server.predictor
    with torch.device("meta"):
        plain = Code2Vec(predictor.config.with_updates(use_pallas=False))
    plain.load_state_dict(predictor.model.state_dict(), assign=True)
    plain.eval()
    worst, top1_agree, coalesced = 0.0, 0, 0
    for req, resp in zip(requests, responses):
        if not resp.get("ok"):
            raise AssertionError(f"request {req['id']} failed: {resp}")
        (entry,) = resp["methods"]
        cv = np.asarray(entry["code_vector"], np.float32)
        if not np.isfinite(cv).all():
            raise AssertionError(f"request {req['id']}: non-finite code vector")
        coalesced = max(coalesced, entry["timing"]["coalesced"])
        ctx = np.asarray(subsample(req["contexts"], max_width), np.int32)
        width = nearest_bucket_width(len(ctx), ladder)
        ids = np.zeros((3, 1, width), np.int32)
        ids[:, 0, : len(ctx)] = ctx.T
        with torch.inference_mode():
            logits_ref, cv_ref, _ = plain(
                *(torch.from_numpy(x).to(predictor.device) for x in ids),
                quant_tables=predictor.quant_tables,
            )
        cv_ref = cv_ref[0].cpu().numpy()
        worst = max(worst, float(np.abs(cv - cv_ref).max()))
        np.testing.assert_allclose(cv, cv_ref, rtol=rtol, atol=atol)
        if req["op"] == "predict":
            ref = logits_ref[0].cpu().numpy()
            ref_top = softmax_top_k(ref, TOP11["label_count"], 1)[0][0]
            served = predictor.label_vocab.stoi[entry["predictions"][0]["name"]]
            # a served top-1 that ties the reference's within the logit
            # tolerance is the same answer up to rounding
            top1_agree += served == ref_top or ref[ref_top] - ref[served] <= SERVE_ATOL
    n_predict = sum(r["op"] == "predict" for r in requests)
    if top1_agree != n_predict:
        raise AssertionError(f"{label}: top-1 agrees on {top1_agree}/{n_predict}")
    if health["post_warmup_compiles"] != 0:
        raise AssertionError(f"{label}: post-warmup compiles {health}")
    if health["ladder"] != list(ladder):
        raise AssertionError(f"{label}: served ladder {health['ladder']}, expected {ladder}")
    if coalesced < 2:
        raise AssertionError(f"{label}: pipelined requests never coalesced")
    long_lat = [t for t, req in zip(latencies, requests) if len(req["contexts"]) > BAG]
    result = {
        "route": impl, "table_dtype": table_dtype, "requests": len(requests),
        "startup_s": startup_s, "launches": counts,
        "sequential_p50_ms": float(np.percentile(latencies, 50)),
        "sequential_p99_ms": float(np.percentile(latencies, 99)),
        "sequential_long_p50_ms": float(np.percentile(long_lat, 50)) if long_lat else None,
        "sequential_long_n": len(long_lat),
        "pipelined_requests_per_s": (len(requests) - n_seq) / pipelined_s,
        "max_coalesced": coalesced, "max_abs_err_vs_plain": worst,
        "top1_agree": f"{top1_agree}/{n_predict}",
        "post_warmup_compiles": health["post_warmup_compiles"],
        "executables": health["executables"],
    }
    print(f"serve {label}: {len(requests)} requests ok, startup "
          f"{startup_s:.2f}s, one-at-a-time p50 {result['sequential_p50_ms']:.3f} ms "
          f"p99 {result['sequential_p99_ms']:.3f} ms (bags > {BAG}: p50 "
          f"{result['sequential_long_p50_ms']} ms over {len(long_lat)}), pipelined "
          f"{result['pipelined_requests_per_s']:.1f} req/s (max {coalesced} coalesced), "
          f"max |cv - plain| {worst:.3e}, top-1 {result['top1_agree']}, "
          f"post-warmup compiles 0, launches {counts} [{smi}]", flush=True)
    return result


SERVE_ROUTES = [  # (route, table dtype, kernel launch key it must show)
    ("fused", "f32", "fused_f32"),
    ("fused", "int8", "fused_int8"),
    ("fused", "bf16", "fused_bf16"),
    ("gather_split", "f32", "gather_split"),
    ("pool_only", "f32", "pool"),
]


def phase_serve(torch, smi, device, model_dir: Path) -> dict:
    requests = make_requests(96, seed=7)
    out = {}
    for impl, dt, key in SERVE_ROUTES:
        res = serve_route(torch, model_dir, impl, dt, requests, smi, device)
        if res["launches"].get(key, 0) < 1:
            raise AssertionError(f"route {impl}/{dt} never launched kernel {key}")
        out[key] = res
        torch.cuda.empty_cache()
    return out


def phase_longbag(torch, smi, device, model_dir: Path) -> dict:
    """The long-bag route once per K4 variant: the ladder gains the rungs
    derive_longbag_ladder gives above the training bag for this traffic."""
    from code2vec_tpu_torch.data.pipeline import derive_longbag_ladder

    lengths = longbag_lengths(96, seed=11)
    hist_len, hist_w = np.unique(lengths, return_counts=True)
    rungs = derive_longbag_ladder(hist_len, hist_w, BAG)
    if rungs != LONGBAG_RUNGS:
        raise AssertionError(f"derive_longbag_ladder gave {rungs}, expected {LONGBAG_RUNGS}")
    requests = make_requests(96, seed=13, lengths=lengths)
    extra = ["--longbag_widths", ",".join(map(str, rungs))]
    out = {}
    for mode in K4_MODES:
        for dt in ("f32", "bf16", "int8"):
            key = f"{mode}_{dt}"
            res = serve_route(torch, model_dir, "fused", dt, requests, smi, device,
                              extra=extra + ["--pallas_softmax", mode] * (mode != "online"),
                              ladder=LADDER + rungs, rtol=0.0, atol=TOL)
            if res["launches"].get(key, 0) < 1:
                raise AssertionError(f"long-bag route {key} never launched K4")
            out[key] = res
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: retrieval
# ---------------------------------------------------------------------------


def ann_corpus():
    """bench.py's clustered ANN corpus at the served encode width: rows
    around 8,192 true centers, queries = perturbed corpus points."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(ANN_CLUSTERS, ANN_DIM)).astype(np.float32)
    member = rng.integers(0, ANN_CLUSTERS, ANN_N)
    rows = (centers[member] + ANN_NOISE * rng.normal(size=(ANN_N, ANN_DIM))).astype(np.float32)
    q_src = rng.integers(0, ANN_N, ANN_QUERIES)
    queries = (rows[q_src] + 0.05 * rng.normal(size=(ANN_QUERIES, ANN_DIM))).astype(np.float32)
    return rows, queries


def lut_bound(probed, counts, cap, m):
    """Bytes K5 must move: the real rows of each distinct probed cell once
    (M code bytes, scale and bias per row), the LUT, the probed ids and
    every score slot (pad slots are written ``-inf``); ops: M adds + 2 per
    real row scored."""
    q, p = probed.shape
    cells, counts = probed.cpu().numpy(), np.asarray(counts, np.int64)
    rows_once = int(counts[np.unique(cells)].sum())
    nbytes = rows_once * (m + 8) + 4 * (q * m * 256 + q * p + q * p * cap)
    return nbytes, int(counts[cells].sum()) * (m + 2)


def same_shortlist(scores_a, ids_a, scores_b, ids_b) -> bool:
    """Equal as id sets: every id scoring above the cut is in both (ids
    within 1e-5 of the cut may trade places), and as many of each."""
    for sa, ia, sb, ib in zip(scores_a, ids_a, scores_b, ids_b):
        fa, fb = np.isfinite(sa), np.isfinite(sb)
        if fa.sum() != fb.sum():
            return False
        if not fa.any():
            continue
        cut = sa[fa].min()
        if set(ia[fa & (sa > cut + 1e-5)].tolist()) != set(ib[fb & (sb > cut + 1e-5)].tolist()):
            return False
    return True


def neighbors_split(torch, bench, searcher, queries) -> dict:
    """Device ms of each stage of ``AnnSearcher.search`` for one query
    (ann/index.py), each timed alone as the kernels are (cold L2, the card
    busy while the host enqueues), on the searcher's own tensors; then the
    whole chain in one timing, and the host's wall time of ``search``
    (median of 20 calls), whose excess over the chain is host work."""
    from code2vec_tpu_torch.ann.index import normalize_rows
    from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells

    s = searcher
    cap, n_probe, m = s.capacity, s.n_probe, s.m
    qd = torch.from_numpy(normalize_rows(queries[:1])).to(s.device)
    with torch.inference_mode():
        def coarse():
            return qd @ s._centroids.T + s._cell_bias[None, :]

        def probe():
            top, probed = torch.topk(cell_scores, n_probe, dim=1)
            return top, probed, probed.to(torch.int32)

        def lut():
            return torch.einsum("qmd,mjd->qmj", qd.reshape(1, m, s.dim // m),
                                s._codebooks).contiguous()

        def k5():
            return lut_score_cells(lut_t, probed32, s._codes, s._scales, s._bias)

        def shortlist():
            return torch.topk((adc + coarse_top[:, :, None]).reshape(1, n_probe * cap),
                              s.shortlist, dim=1)

        def ids():
            p_idx = torch.div(flat_idx, cap, rounding_mode="floor")
            return s._ids[torch.gather(probed, 1, p_idx), flat_idx - p_idx * cap]

        def to_host():
            return top.cpu().numpy(), rows.cpu().numpy()

        def chain():
            nonlocal cell_scores, coarse_top, probed, probed32, lut_t, adc, top, flat_idx, rows
            cell_scores = coarse()
            coarse_top, probed, probed32 = probe()
            lut_t = lut()
            adc = k5()
            top, flat_idx = shortlist()
            rows = ids()
            return to_host()

        cell_scores = coarse_top = probed = probed32 = lut_t = adc = top = flat_idx = rows = None
        chain()
        out = {name: bench.time_ms(fn) for name, fn in (
            ("coarse_matmul", coarse), ("topk_probes", probe), ("lut_einsum", lut),
            ("k5", k5), ("add_topk_shortlist", shortlist), ("id_gather", ids),
            ("copy_to_host", to_host))}
        out["stages_sum"] = sum(out.values())
        out["chain"] = bench.time_ms(chain)
    wall = []
    for _ in range(20):
        t = time.perf_counter()
        s.search(queries[:1])
        wall.append((time.perf_counter() - t) * 1e3)
    out["search_host_wall_ms"] = float(np.median(wall))
    return out


def phase_retrieval(torch, smi, device, model_dir: Path) -> dict:
    from code2vec_tpu_torch.ann import lut_kernel
    from code2vec_tpu_torch.ann.index import AnnSearcher, build_index, save_index
    from code2vec_tpu_torch.ann.lut_kernel import (
        lut_grid,
        lut_score_cells,
        lut_score_cells_reference,
    )
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server
    from code2vec_tpu_torch.serve.retrieval import AnnRetrievalIndex, RetrievalIndex

    t0 = time.perf_counter()
    rows, queries = ann_corpus()
    labels = [f"m{i}" for i in range(ANN_N)]
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index, unit = build_index(rows, n_list=ANN_NLIST, m=ANN_M, seed=0, kmeans_iters=20,
                              pq_iters=15, device=device)
    build_s = time.perf_counter() - t0
    cap = index.meta["capacity"]
    print(f"ann index: N={ANN_N} dim={ANN_DIM} n_list={ANN_NLIST} m={ANN_M} capacity={cap} "
          f"built on the card in {build_s:.1f}s (corpus made in {corpus_s:.1f}s) [{smi}]",
          flush=True)
    if not np.array_equal(np.sort(index.ids[index.ids >= 0]), np.arange(ANN_N)) or \
            int(index.cell_counts.sum()) != ANN_N:
        raise AssertionError("ann index: not every row lands in exactly one cell")
    path = model_dir / "ann.index"
    save_index(str(path), index, unit, labels,
               defaults={"n_probe": ANN_PROBE, "shortlist": ANN_SHORTLIST})

    # K5 against its plain version on the index's shapes
    bench = KernelBench(torch, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    searcher = AnnSearcher(index, n_probe=max(p for _, p in K5_SHAPES), shortlist=ANN_SHORTLIST,
                           device=device)
    g = np.random.default_rng(3)
    k5_rows = []
    for q, n_probe in K5_SHAPES:
        qs = rows[g.integers(0, ANN_N, q)] + 0.05 * g.normal(size=(q, ANN_DIM)).astype(np.float32)
        qd = torch.from_numpy(qs / np.linalg.norm(qs, axis=1, keepdims=True)).to(device)
        cell_scores = qd @ searcher._centroids.T + searcher._cell_bias[None, :]
        probed = torch.topk(cell_scores, n_probe, dim=1).indices.to(torch.int32)
        lut = torch.einsum("qmd,mjd->qmj", qd.reshape(q, ANN_M, ANN_DIM // ANN_M),
                           searcher._codebooks).contiguous()
        args = (lut, probed, searcher._codes, searcher._scales, searcher._bias)
        kernel = lambda: lut_score_cells(*args)  # noqa: E731
        plain = lambda: lut_score_cells_reference(*args)  # noqa: E731
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(torch.isneginf(got), torch.isneginf(ref)):
            raise AssertionError(f"K5 at Q={q} P={n_probe}: -inf masks differ")
        fin = torch.isfinite(ref)
        err = (got[fin] - ref[fin]).abs().max().item()
        if err > TOL:
            raise AssertionError(f"K5 at Q={q} P={n_probe}: max |err| {err:.3e} > {TOL}")
        nbytes, flops = lut_bound(probed, index.cell_counts, cap, ANN_M)
        bound_s, bound_by = bound_of(nbytes, flops / F32_FLOP_PER_S)
        ms = bench.time_ms(kernel)
        lo, hi = bench.spread
        row = {"Q": q, "P": n_probe, "max_abs_err": err, "ms": ms, "ms_min_max": [lo, hi],
               "plain_ms": bench.time_ms(plain), "library_ms": None,
               "bound_ms": bound_s * 1e3, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops, "grid_rows_cells": list(lut_grid(q, n_probe, cap, sms))}
        k5_rows.append(row)
        print(f"kernel K5 lut_score Q={q:2d} P={n_probe:2d} C={cap} max_abs_err={err:.3e} "
              f"ms={ms:.4f} (launches {lo:.4f}-{hi:.4f}) plain_ms={row['plain_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({bound_by}) CTA rows x cells "
              f"{row['grid_rows_cells']}",
              flush=True)
    del searcher
    exact = RetrievalIndex(labels, rows, device=device)

    # the server: the model dir, the ann backend from the saved container
    args = build_parser().parse_args([
        "--model_path", str(model_dir),
        "--terminal_idx_path", str(model_dir / "terminal_idxs.txt"),
        "--path_idx_path", str(model_dir / "path_idxs.txt"),
        "--batch_sizes", ",".join(map(str, BATCH_SIZES)), "--device", str(device),
        "--retrieval_backend", "ann", "--ann_index_path", str(path),
    ])
    server = build_server(args)
    ctx_requests = make_requests(ANN_CONTEXT_QUERIES, seed=17)
    answers, timing = {}, {}
    try:
        ann = server.retrieval
        health = server.handle({"op": "health"})
        if health["retrieval"]["backend"] != "ann" or health["retrieval"]["size"] != ANN_N:
            raise AssertionError(f"retrieval health block: {health['retrieval']}")
        for backend, index_ in (("exact", exact), ("ann", ann)):
            server.retrieval = index_
            server.handle({"op": "neighbors", "vector": queries[0].tolist(), "top_k": 10})
            reset_launch_counts()
            lat, got = [], []
            for i in range(ANN_QUERIES):
                t = time.perf_counter()
                resp = server.handle({"op": "neighbors", "vector": queries[i].tolist(),
                                      "top_k": 10})
                lat.append((time.perf_counter() - t) * 1e3)
                if not resp.get("ok") or len(resp["neighbors"]) != 10:
                    raise AssertionError(f"{backend} neighbors query {i}: {resp}")
                got.append([int(n["name"][1:]) for n in resp["neighbors"]])
            ctx_lat = []
            for req in ctx_requests:
                req = {"op": "neighbors", "contexts": req["contexts"], "top_k": 10}
                t = time.perf_counter()
                resp = server.handle(req)
                ctx_lat.append((time.perf_counter() - t) * 1e3)
                (entry,) = resp["methods"]
                if len(entry["neighbors"]) != 10 or "code_vector" in entry:
                    raise AssertionError(f"{backend} contexts-form neighbors: {resp}")
            counts = launch_counts()
            answers[backend] = got
            timing[backend] = {
                "vector_p50_ms": float(np.percentile(lat, 50)),
                "vector_p99_ms": float(np.percentile(lat, 99)),
                "contexts_p50_ms": float(np.percentile(ctx_lat, 50)),
                "contexts_p99_ms": float(np.percentile(ctx_lat, 99)),
                "launches": counts,
            }
            print(f"neighbors {backend}: {ANN_QUERIES} vector queries one at a time p50 "
                  f"{timing[backend]['vector_p50_ms']:.3f} ms p99 "
                  f"{timing[backend]['vector_p99_ms']:.3f} ms; {ANN_CONTEXT_QUERIES} contexts "
                  f"queries p50 {timing[backend]['contexts_p50_ms']:.3f} ms p99 "
                  f"{timing[backend]['contexts_p99_ms']:.3f} ms; launches {counts} [{smi}]",
                  flush=True)
        server.retrieval = ann
    finally:
        server.close()
    if timing["ann"]["launches"].get("lut_score", 0) < 1:
        raise AssertionError("the ann neighbors queries never launched K5")

    # the searcher with K5 against the same searcher with the plain scoring:
    # search() looks K5's wrapper up in its module at call time
    s_k, i_k = ann.searcher.search(queries)
    lut_kernel.lut_score_cells = lut_score_cells_reference
    try:
        s_p, i_p = ann.searcher.search(queries)
    finally:
        lut_kernel.lut_score_cells = lut_score_cells
    if not same_shortlist(s_k, i_k, s_p, i_p):
        raise AssertionError("ann shortlists with K5 differ from the plain scoring's")
    split = neighbors_split(torch, bench, ann.searcher, queries)
    print("neighbors split (ann, one query, n_probe "
          f"{ann.searcher.n_probe}, device ms per stage, cold L2 each): {json.dumps(split)} "
          f"[{smi}]", flush=True)
    exact_sets = [set(a) for a in answers["exact"]]
    recall = {}
    for n_probe in (8, 16, 32):
        arm = AnnRetrievalIndex(labels, unit, index, n_probe=n_probe, shortlist=ANN_SHORTLIST,
                                device=device)
        hits = sum(len({int(n[1:]) for n, _ in arm.top_k(queries[i], 10)} & exact_sets[i])
                   for i in range(ANN_QUERIES))
        recall[n_probe] = {"recall@10": hits / (10 * ANN_QUERIES),
                           "probed_fraction": arm.probed_fraction(queries)}
        del arm
    served = sum(len(set(a) & e) for a, e in zip(answers["ann"], exact_sets))
    print(f"ann recall@10 vs exact: {json.dumps(recall)}; served (n_probe {ANN_PROBE}) "
          f"{served / (10 * ANN_QUERIES):.4f}", flush=True)
    return {"build_s": build_s, "capacity": cap, "k5_rows": k5_rows, "timing": timing,
            "neighbors_split": split,
            "recall": recall, "served_recall@10": served / (10 * ANN_QUERIES),
            "launches": timing["ann"]["launches"]}


# ---------------------------------------------------------------------------
# phase 6b: serve_control — the coalescing invariant, hot-swap, HTTP, SIGTERM, the fleet
# ---------------------------------------------------------------------------

# (label, serve flags, the launch keys the check must show); long-bag rungs
# serve through K4 online (auto) or the mode asked for
# (label, flags, kernels, micro-batch sizes): K1 also at 128, above the
# 66 rows where its cluster once shrank with B
COALESCE_ROUTES = [
    ("K3 f32 + K4 online", ["--table_dtype", "f32"], ("fused_f32", "online_f32"), BATCH_SIZES),
    ("K3 bf16 + K4 online", ["--table_dtype", "bf16"], ("fused_bf16", "online_bf16"),
     BATCH_SIZES),
    ("K3 int8 + K4 online", ["--table_dtype", "int8"], ("fused_int8", "online_int8"),
     BATCH_SIZES),
    ("K4 online f32", ["--pallas_softmax", "online"], ("online_f32",), BATCH_SIZES),
    ("K4 two_pass f32", ["--pallas_softmax", "two_pass"], ("two_pass_f32",), BATCH_SIZES),
    ("K2 f32", ["--pallas_impl", "gather_split"], ("gather_split",), BATCH_SIZES),
    ("K1 f32", ["--pallas_impl", "pool_only"], ("pool",), BATCH_SIZES + (128,)),
]
COALESCE_RTOL, COALESCE_ATOL = 1e-5, 1e-6  # logits (JAX serve/swap.py:233-240)
# the plain route (no kernel: the encode in fixed cuBLAS slabs, the pool's
# batch-free form with gradients off) is held to the same invariant
COALESCE_PLAIN = ("plain f32", [], (), BATCH_SIZES)


def coalescing_check(torch, model_dir: Path, device, smi) -> dict:
    """The serving invariant the hot-swap gate holds (JAX serve/swap.py:
    211-245) on every route: as many requests at each rung as the route's
    top micro-batch (lengths in the rung's upper half), served at each of
    its micro-batch sizes and one at a time through the engine; each
    request's code vector from every batch must equal its batch-1 vector
    bitwise, its logits within rtol 1e-5 / atol 1e-6. Last, the plain
    route (the same weights without a kernel) is run the same way and held
    to the same gate. Every mismatch is collected, then the check fails."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.predict import Predictor
    from code2vec_tpu_torch.serve.engine import ServingEngine

    rungs = LADDER + LONGBAG_RUNGS
    c = TOP11
    out, bad = {}, []
    for label, flags, keys, sizes in COALESCE_ROUTES + [COALESCE_PLAIN]:
        plain_route = label == COALESCE_PLAIN[0]
        report = bad
        opts = dict(zip(flags[::2], flags[1::2]))
        impl = opts.get("--pallas_impl", "fused")
        longbag = LONGBAG_RUNGS if impl == "fused" else ()
        predictor = Predictor(
            str(model_dir), str(model_dir / "terminal_idxs.txt"),
            str(model_dir / "path_idxs.txt"), table_dtype=opts.get("--table_dtype", "f32"),
            device=device, pallas_impl=impl,
            pallas_softmax=opts.get("--pallas_softmax", "auto"), longbag_widths=longbag,
        )
        if plain_route:
            from code2vec_tpu_torch.models.code2vec import Code2Vec

            with torch.device("meta"):
                plain = Code2Vec(predictor.config.with_updates(use_pallas=False))
            plain.load_state_dict(predictor.model.state_dict(), assign=True)
            predictor.model = plain.eval()
            predictor.config = plain.config
        engine = ServingEngine(predictor, batch_sizes=sizes)
        engine.prepare()
        reset_launch_counts()
        g = np.random.default_rng(29)
        route = {"widths": {}}
        every = []
        t0 = time.perf_counter()
        for lo, width in zip((0,) + rungs, rungs):
            if width > engine.max_width:
                break
            top = sizes[-1]
            lens = g.integers(max(lo + 1, width // 2), width + 1, top)
            reqs = [np.stack([g.integers(1, c["terminal_count"], n),
                              g.integers(1, c["path_count"], n),
                              g.integers(0, c["terminal_count"], n)], 1).astype(np.int32)
                    for n in lens]
            singles = [engine.run(*engine.pad_requests([r])[:3]) for r in reqs]
            n_bits, worst_logit = 0, 0.0
            for size in sizes[1:]:
                for base in range(0, top, size):
                    group = reqs[base:base + size]
                    logits, cvs, _ = engine.run(*engine.pad_requests(group)[:3])
                    for i in range(len(group)):
                        ref_logits, ref_cv = singles[base + i][0][0], singles[base + i][1][0]
                        if not np.array_equal(cvs[i], ref_cv):
                            n_bits += 1
                            if len(report) < 40:
                                report.append(f"{label} width {width} batch {size}: request "
                                              f"{base + i} ({lens[base + i]} contexts) max |cv "
                                              f"- batch-1| {np.abs(cvs[i] - ref_cv).max():.3e}")
                        worst_logit = max(worst_logit,
                                          float(np.abs(logits[i] - ref_logits).max()))
                        if not np.allclose(logits[i], ref_logits, rtol=COALESCE_RTOL,
                                           atol=COALESCE_ATOL):
                            report.append(f"{label} width {width} batch {size}: request "
                                          f"{base + i} logits beyond rtol {COALESCE_RTOL} / "
                                          f"atol {COALESCE_ATOL}")
            route["widths"][width] = {"cv_not_bitwise": n_bits,
                                      "max_abs_logit_diff": worst_logit}
            every.extend(zip(reqs, singles))
        # one micro-batch of requests from every rung, padded to the top
        # one (the golden set's mix, serve/swap.py): K3 and K4 online are
        # one kernel, so the short bags keep their bits at 2048
        per = sizes[-1] // len(route["widths"])
        mixed = [every[i * sizes[-1] + j] for i in range(len(route["widths"]))
                 for j in range(per)]
        _, cvs, _ = engine.run(*engine.pad_requests([r for r, _ in mixed])[:3])
        n_mixed = sum(not np.array_equal(cvs[i], single[1][0])
                      for i, (_, single) in enumerate(mixed))
        route["mixed_widths"] = {"requests": len(mixed), "cv_not_bitwise": n_mixed}
        if n_mixed:
            report.append(f"{label}: {n_mixed}/{len(mixed)} vectors of a mixed-width batch differ "
                       "from batch-1")
        counts = launch_counts()
        missing = [k for k in keys if counts.get(k, 0) < 1]
        if missing:
            bad.append(f"{label}: kernels {missing} never launched ({counts})")
        route.update(launches=counts, seconds=time.perf_counter() - t0)
        out[label] = route
        if plain_route:
            moved = sum(w["cv_not_bitwise"] for w in route["widths"].values())
            rows = len(sizes[1:]) * sizes[-1] * len(route["widths"])
            route["rows_not_bitwise"] = moved + n_mixed
            print(f"coalescing plain: {moved} of {rows} rows (and {n_mixed} of {len(mixed)} in "
                  f"the mixed-width batch) whose code vector's bits move with the micro-batch; "
                  f"gated at 0 [{smi}]", flush=True)
        print(f"coalescing {label}: per width (vectors not bitwise of "
              f"{len(sizes[1:]) * sizes[-1]}, max |logit diff|): "
              f"{json.dumps(route['widths'])}, launches {counts} [{smi}]", flush=True)
        del engine, predictor
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError("coalesced != batch-1:\n  " + "\n  ".join(bad))
    return out


CTL_CODE_VEC_ROWS = 16_384  # rows of each dir's code.vec (the exact backend)
CTL_PROBES = 24  # requests answered before a swap, after it and after the rollback
CTL_SIGTERM_REQUESTS = 64
CTL_MEMORY_SLACK = 16 * 2**20  # bytes: two resident generations, within this


def write_code_vec(path: Path, seed: int) -> None:
    from code2vec_tpu_torch.formats.vectors_io import append_code_vectors, write_code_vectors_header

    rows = np.random.default_rng(seed).normal(size=(CTL_CODE_VEC_ROWS, TOP11["encode_size"]))
    write_code_vectors_header(path, CTL_CODE_VEC_ROWS, TOP11["encode_size"])
    append_code_vectors(path, [f"m{i}" for i in range(CTL_CODE_VEC_ROWS)],
                        rows.astype(np.float32))


def fresh_request(i: int) -> dict:
    """Request ``i`` of an endless stream of distinct bags (a result cache
    never answers one), 1-200 contexts, predict and embed in turn."""
    c = TOP11
    rng = np.random.default_rng(1000 + i)
    n = int(rng.integers(1, BAG + 1))
    ctx = np.stack([rng.integers(1, c["terminal_count"], n), rng.integers(1, c["path_count"], n),
                    rng.integers(0, c["terminal_count"], n)], axis=1)
    return {"id": i, "op": "predict" if i % 2 == 0 else "embed", "contexts": ctx.tolist(),
            "top_k": 5, "include_vector": True}


class Trickle:
    """Requests on a thread of their own while the main thread swaps: one
    at a time, then 8 pipelined, over and over; ``request(i)`` gives the
    i-th. Each request's latency and outcome is kept under the label the
    main thread set (``phase``)."""

    def __init__(self, server, request):
        import threading

        self.server, self.request = server, request
        self.phase = "before"
        self.records: list[tuple[str, float, bool]] = []
        self.failures: list[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="c2v-smoke-trickle", daemon=True)
        self._thread.start()

    def _note(self, phase, t0, resp):
        ok = bool(resp.get("ok"))
        self.records.append((phase, (time.perf_counter() - t0) * 1e3, ok))
        if not ok:
            self.failures.append(resp)

    def _run(self):
        i = 0
        while not self._stop.is_set():
            phase, t0 = self.phase, time.perf_counter()
            self._note(phase, t0, self.server.handle(self.request(i)))
            burst = [self.request(i + k) for k in range(1, 9)]
            phase, t0 = self.phase, time.perf_counter()
            for resolver in [self.server.handle_async(r) for r in burst]:
                self._note(phase, t0, resolver())
            i += 9

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(60)
        out = {}
        for phase in ("before", "during", "after", "rolled_back"):
            lat = [ms for p, ms, _ in self.records if p == phase]
            if lat:
                p50, p99 = percentiles(lat)
                out[phase] = {"requests": len(lat), "p50_ms": p50, "p99_ms": p99}
        out["failed"] = len(self.failures)
        return out


def ctl_args(model_dir: Path, device, *extra) -> list[str]:
    return ["--model_path", str(model_dir),
            "--terminal_idx_path", str(model_dir / "terminal_idxs.txt"),
            "--path_idx_path", str(model_dir / "path_idxs.txt"),
            "--device", str(device), *extra]


def wait_swap(server, timeout=600.0) -> dict:
    t0 = time.perf_counter()
    while True:
        status = server.handle({"op": "swap_status"})["swap"]
        if status["state"] == "idle":
            return status
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"swap still {status['state']} after {timeout} s")
        time.sleep(0.05)


def probe_vectors(server, probes) -> np.ndarray:
    out = []
    for req in probes:
        resp = server.handle({**req, "op": "embed"})
        if not resp.get("ok"):
            raise AssertionError(f"probe failed: {resp}")
        out.append(resp["methods"][0]["code_vector"])
    return np.asarray(out, np.float32)


def plain_vectors(torch, predictor, probes, ladder) -> np.ndarray:
    """The probes' code vectors from ``predictor``'s weights with no
    kernel, on the card, at full f32 precision."""
    from code2vec_tpu_torch.data.pipeline import nearest_bucket_width
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.predict import subsample

    with torch.device("meta"):
        plain = Code2Vec(predictor.config.with_updates(use_pallas=False))
    plain.load_state_dict(predictor.model.state_dict(), assign=True)
    plain.eval()
    out = []
    for req in probes:
        ctx = np.asarray(subsample(req["contexts"], ladder[-1]), np.int32)
        ids = np.zeros((3, 1, nearest_bucket_width(len(ctx), ladder)), np.int32)
        ids[:, 0, : len(ctx)] = ctx.T
        with torch.inference_mode():
            _, cv, _ = plain(*(torch.from_numpy(x).to(predictor.device) for x in ids),
                             quant_tables=predictor.quant_tables)
        out.append(cv[0].cpu().numpy())
    return np.asarray(out, np.float32)


def generation_bytes(torch) -> int:
    """``memory_allocated`` with the cuBLAS workspaces dropped first: each
    thread that ran a library product holds a workspace until it is
    cleared, which is per-thread scratch, not a generation's."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def ctl_hot_swap(torch, smi, device, dirs) -> dict:
    """(b): A served with a trickle; reload B, rollback, a NaN reload, a
    third swap; memory and the handle ledger after it; flights."""
    from code2vec_tpu_torch.obs.handles import handles_snapshot
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    ladder = LADDER + LONGBAG_RUNGS
    lengths = longbag_lengths(96, seed=31)
    trickle_reqs = make_requests(96, seed=37, lengths=lengths)
    probes = make_requests(CTL_PROBES, seed=41, lengths=longbag_lengths(CTL_PROBES, seed=43))
    torch.cuda.empty_cache()
    base_alloc = generation_bytes(torch)
    args = build_parser().parse_args(ctl_args(
        dirs["A"], device, "--batch_sizes", ",".join(map(str, BATCH_SIZES)),
        "--longbag_widths", ",".join(map(str, LONGBAG_RUNGS)), "--handle_debug"))
    t0 = time.perf_counter()
    server = build_server(args)
    out = {"startup_s": time.perf_counter() - t0}
    try:
        one_gen = generation_bytes(torch) - base_alloc
        before = probe_vectors(server, probes)
        trickle = Trickle(server, lambda i: trickle_reqs[i % len(trickle_reqs)])
        time.sleep(2.0)
        trickle.phase = "during"
        t0 = time.perf_counter()
        resp = server.handle({"op": "reload", "model_path": str(dirs["B"]), "wait": False})
        if not resp.get("ok") or resp["swap"]["state"] == "idle":
            raise AssertionError(f"reload B was not accepted as running: {resp}")
        status = wait_swap(server)
        swap_s = time.perf_counter() - t0
        trickle.phase = "after"
        last = status["last_swap"]
        if last["outcome"] != "committed":
            raise AssertionError(f"swap to B did not commit: {status}")
        time.sleep(2.0)
        after = probe_vectors(server, probes)
        want = plain_vectors(torch, server.predictor, probes, ladder)
        np.testing.assert_allclose(after, want, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        resp = server.handle({"op": "rollback"})
        trickle.phase = "rolled_back"
        if not resp.get("ok") or resp["swap"]["active_version"] != status["previous_version"]:
            raise AssertionError(f"rollback: {resp}")
        rolled = probe_vectors(server, probes)
        if not np.array_equal(rolled, before):
            raise AssertionError("rollback: answers differ from those before the swap")
        time.sleep(1.0)
        trickle_stats = trickle.stop()
        if trickle_stats["failed"]:
            raise AssertionError(f"{trickle_stats['failed']} trickle requests failed: "
                                 f"{trickle.failures[:3]}")
        two_gen = generation_bytes(torch) - base_alloc  # A active, B resident
        # a bad checkpoint: the build warms it, validation finds the NaN
        active = server.version
        resp = server.handle({"op": "reload", "model_path": str(dirs["NaN"]), "wait": True})
        if resp.get("error_kind") != "swap_failed" or server.version != active:
            raise AssertionError(f"NaN reload: {resp}")
        nan_error = resp["error"]
        # the third swap: the oldest resident generation (B) is released
        resp = server.handle({"op": "reload", "model_path": str(dirs["B"]), "wait": True})
        if not resp.get("ok"):
            raise AssertionError(f"third swap: {resp}")
        three_gen = generation_bytes(torch) - base_alloc
        open_handles = handles_snapshot()
        n_gens = (open_handles.get("open") or {}).get("generation")
        if abs(three_gen - two_gen) > CTL_MEMORY_SLACK or n_gens != 2:
            raise AssertionError(
                f"after the third swap {three_gen / 2**20:.1f} MiB allocated against "
                f"{two_gen / 2**20:.1f} MiB for two generations, {n_gens} generations open")
        flights = server.handle({"op": "flights"})
        if not flights.get("ok") or flights["recorded"] < 1:
            raise AssertionError(f"flights: {flights}")
        health = server.handle({"op": "health"})
    finally:
        server.close()
    out.update(
        swap_s=swap_s, build_s=last["build_ms"] / 1e3, validate_s=last["validate_ms"] / 1e3,
        golden_requests=last["golden_requests"], golden_recall=last.get("recall"),
        trickle=trickle_stats, max_abs_err_vs_plain_B=float(np.abs(after - want).max()),
        nan_reload_error=nan_error,
        memory_mib={"one_generation": one_gen / 2**20, "two_generations": two_gen / 2**20,
                    "after_third_swap": three_gen / 2**20},
        generations_open=n_gens, flights_recorded=flights["recorded"],
        post_warmup_compiles=health["post_warmup_compiles"],
    )
    print(f"hot-swap: reload A -> B committed in {swap_s:.2f} s (build "
          f"{out['build_s']:.2f} s, validation {out['validate_s']:.2f} s over "
          f"{out['golden_requests']} golden requests, recall {out['golden_recall']}); trickle "
          f"{json.dumps(trickle_stats)}; B vs plain max |err| "
          f"{out['max_abs_err_vs_plain_B']:.3e}; rollback bitwise; NaN reload refused "
          f"({nan_error[:80]}...); memory MiB {json.dumps(out['memory_mib'])}, "
          f"{n_gens} generations open; {flights['recorded']} flights [{smi}]", flush=True)
    return out


def ctl_http(torch, smi, device, dirs, ann_index: Path | None) -> dict:
    """(c): a server on HTTP (the ann backend over the retrieval phase's
    index when there is one): data and control ops, /healthz, /metrics,
    400 / 429 / 500, an ann reload's golden recall, per-op latency over
    HTTP beside the same server in process."""
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server
    from code2vec_tpu_torch.serve.protocol import make_http_server

    extra = ["--batch_sizes", "1,8", "--max_pending", "8"]
    if ann_index is not None:
        extra += ["--retrieval_backend", "ann", "--ann_index_path", str(ann_index)]
    server = build_server(build_parser().parse_args(ctl_args(dirs["A"], device, *extra)))
    httpd = make_http_server(server, "127.0.0.1", 0)
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.1},
                              daemon=True)
    thread.start()

    def call(path, body=None, raw=None):
        data = raw if raw is not None else (json.dumps(body).encode() if body is not None
                                            else None)
        req = urllib.request.Request(base + path, data=data,
                                     method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    out = {}
    try:
        reqs = make_requests(64, seed=47)
        vec = np.random.default_rng(5).normal(size=TOP11["encode_size"]).tolist()
        codes = {}
        for op, body in (("predict", reqs[0]), ("embed", reqs[1]),
                         ("neighbors", {"op": "neighbors", "vector": vec, "top_k": 10}),
                         ("health", {"op": "health"}), ("swap_status", {"op": "swap_status"}),
                         ("flights", {"op": "flights"})):
            codes[op], _ = call("/", body)
        codes["GET /healthz"], _ = call("/healthz")
        codes["GET /metrics"], metrics = call("/metrics")
        codes["bad body"], _ = call("/", raw=b"{not json")
        codes["no contexts"], _ = call("/", {"op": "predict"})
        codes["rollback, none resident"], _ = call("/", {"op": "rollback"})
        want = {"bad body": 400, "no contexts": 400, "rollback, none resident": 400}
        for key, code in codes.items():
            if code != want.get(key, 200):
                raise AssertionError(f"HTTP {key}: status {code}, expected {want.get(key, 200)}")
        text = metrics.decode()
        for name in ("c2v_build_info", "c2v_serve_op_predict_e2e_ms", "c2v_serve_requests_total",
                     "c2v_serve_queue_depth", "c2v_serve_swaps_committed_total"):
            if name not in text:
                raise AssertionError(f"/metrics has no {name}")
        # 429: the engine held, so one group waits in the batcher and the
        # queue (8) fills; every accepted request is answered once it is let go
        lock = server.engine._lock
        lock.acquire()
        held = True
        try:
            with ThreadPoolExecutor(24) as pool:
                futs = [pool.submit(call, "/", {**r, "op": "embed"}) for r in reqs[:24]]
                time.sleep(3.0)
                lock.release()
                held = False
                flood = [f.result()[0] for f in futs]
        finally:
            if held:
                lock.release()
        if 429 not in flood or set(flood) - {200, 429}:
            raise AssertionError(f"flood statuses {sorted(flood)}")
        codes["flood"] = {str(c): flood.count(c) for c in sorted(set(flood))}
        code, body = call("/", {"op": "reload", "model_path": str(dirs["NaN"]), "wait": True})
        if code != 500 or json.loads(body)["error_kind"] != "swap_failed":
            raise AssertionError(f"NaN reload over HTTP: {code} {body[:200]}")
        codes["reload NaN"] = code
        code, body = call("/", {"op": "reload", "model_path": str(dirs["B"]), "wait": True})
        swap = json.loads(body)["swap"]["last_swap"]
        codes["reload B"] = code
        out["ann_reload"] = {"outcome": swap["outcome"], "recall@10": swap.get("recall"),
                             "floor": 0.9, "error": swap.get("error")}
        if swap["outcome"] == "committed" and (swap.get("recall") or 0) < 0.9:
            raise AssertionError(f"a reload committed below the recall floor: {swap}")
        if swap["outcome"] != "committed" and "recall" not in (swap.get("error") or ""):
            raise AssertionError(f"ann reload: {swap}")
        lat = {}
        for op in ("predict", "embed", "neighbors"):
            for via in ("http", "in_process"):
                times = []
                for r in reqs:
                    body = ({"op": "neighbors", "vector": vec, "top_k": 10} if op == "neighbors"
                            else {**r, "op": op})
                    t0 = time.perf_counter()
                    if via == "http":
                        code, _ = call("/", body)
                        ok = code == 200
                    else:
                        ok = bool(server.handle(body).get("ok"))
                    times.append((time.perf_counter() - t0) * 1e3)
                    if not ok:
                        raise AssertionError(f"{op} via {via} failed")
                p50, p99 = percentiles(times)
                lat[f"{op}/{via}"] = {"p50_ms": p50, "p99_ms": p99}
        out.update(statuses=codes, latency=lat)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(10)
    print(f"http: statuses {json.dumps(out['statuses'])}; ann reload "
          f"{json.dumps(out['ann_reload'])}; p50/p99 ms {json.dumps(out['latency'])} [{smi}]",
          flush=True)
    return out


def ctl_sigterm(smi, device, dirs) -> dict:
    """(d): the serve CLI on stdio as a subprocess on the card: 64
    pipelined requests, SIGTERM right after the last; all 64 answered,
    exit code 0."""
    import signal

    cmd = [sys.executable, "-m", "code2vec_tpu_torch.serve", "--transport", "stdio",
           *ctl_args(dirs["A"], device, "--batch_sizes", ",".join(map(str, BATCH_SIZES)))]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        proc.stdin.write(json.dumps({"id": "ready", "op": "health"}) + "\n")
        proc.stdin.flush()
        ready = json.loads(proc.stdout.readline())
        if ready.get("id") != "ready" or not ready.get("ok"):
            raise AssertionError(f"worker not ready: {ready}")
        startup_s = time.perf_counter() - t0
        for req in make_requests(CTL_SIGTERM_REQUESTS, seed=53):
            proc.stdin.write(json.dumps(req) + "\n")
        proc.stdin.flush()
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=300)
        drain_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    answers = [json.loads(line) for line in stdout.splitlines() if line.strip()]
    ok = [a for a in answers if a.get("ok")]
    if proc.returncode != 0 or len(ok) != CTL_SIGTERM_REQUESTS:
        raise AssertionError(f"SIGTERM drain: exit {proc.returncode}, {len(ok)}/"
                             f"{CTL_SIGTERM_REQUESTS} answered; stderr tail {stderr[-2000:]}")
    print(f"sigterm: worker ready in {startup_s:.1f} s; {len(ok)}/{CTL_SIGTERM_REQUESTS} "
          f"pipelined requests answered after SIGTERM in {drain_s:.2f} s, exit 0 [{smi}]",
          flush=True)
    return {"startup_s": startup_s, "answered": len(ok), "drain_s": drain_s, "exit_code": 0}


def ctl_fleet(smi, device, dirs, single_trickle) -> dict:
    """(e): 2 replicas on the card behind the router (result cache 64 MB)
    under a trickle: a rolling reload to B and a rollback with no failed
    request and never more than one replica swapping; a repeated request
    from the cache with no replica launching; the capacity block; p50/p99
    through the router beside the single server's."""
    from code2vec_tpu_torch.serve.fleet.__main__ import build_parser, build_router

    args = build_parser().parse_args([
        "--replicas", "2", *ctl_args(dirs["A"], device),
        "--batch_sizes", ",".join(map(str, BATCH_SIZES)), "--result_cache_mb", "64",
        "--probe_interval_s", "1.0"])
    t0 = time.perf_counter()
    router, events = build_router(args)
    boot_s = time.perf_counter() - t0
    replicas = list(router._slots)

    def replica_call(op):
        return [h.send({"op": op}).result(120) for h in replicas]

    out = {"boot_s": boot_s}
    try:
        trickle = Trickle(router, fresh_request)
        time.sleep(2.0)
        concurrent_swaps = 0
        for step, request in (("reload", {"op": "reload", "model_path": str(dirs["B"])}),
                              ("rollback", {"op": "rollback"})):
            trickle.phase = "during"
            t0 = time.perf_counter()
            resp = router.handle(request)
            if not resp.get("ok"):
                raise AssertionError(f"fleet {step}: {resp}")
            while True:
                states = [r["swap"]["state"] for r in replica_call("swap_status")]
                concurrent_swaps = max(concurrent_swaps, sum(s != "idle" for s in states))
                rolling = router.handle({"op": "swap_status"})
                if rolling.get("rolling", {}).get("state", "idle") == "idle" and \
                        all(s == "idle" for s in states):
                    break
                time.sleep(0.1)
            out[f"{step}_s"] = time.perf_counter() - t0
            trickle.phase = "after"
            versions = {r["version"] for r in replica_call("health")}
            out[f"versions_after_{step}"] = sorted(versions)
            time.sleep(1.0)
        stats = trickle.stop()
        if stats["failed"] or concurrent_swaps > 1:
            raise AssertionError(f"fleet: {stats['failed']} failed requests, up to "
                                 f"{concurrent_swaps} replicas swapping at once")
        if out["versions_after_reload"][0].split("#")[0] != str(dirs["B"]) or \
                out["versions_after_rollback"][0].split("#")[0] != str(dirs["A"]):
            raise AssertionError(f"fleet versions: {out}")
        # the cache: the same bag twice, the second from router memory
        req = {**make_requests(8, seed=61)[5], "op": "embed"}
        first = router.handle(req)
        launches = [r["kernel_launches"] for r in replica_call("health")]
        hits = router.handle({"op": "health"})["fleet"]["cache"]["hits"]
        again = router.handle(req)
        after = [r["kernel_launches"] for r in replica_call("health")]
        cache = router.handle({"op": "health"})["fleet"]["cache"]
        if cache["hits"] != hits + 1 or after != launches or \
                again["methods"][0]["code_vector"] != first["methods"][0]["code_vector"]:
            raise AssertionError(f"cache: hits {hits} -> {cache['hits']}, launches "
                                 f"{launches} -> {after}")
        time.sleep(2.5)  # a probe cycle: the replicas' perf blocks reach the router
        capacity = router.handle({"op": "health"})["fleet"]["capacity"]
        if not capacity or capacity["max_qps_fleet"] <= 0:
            raise AssertionError(f"fleet capacity: {capacity}")
        out.update(trickle=stats, max_concurrent_swaps=concurrent_swaps, capacity=capacity,
                   replica_launches=after, single_server_trickle=single_trickle)
    finally:
        router.close()
        if events is not None:
            events.close()
    print(f"fleet: 2 replicas booted in {boot_s:.1f} s; rolling reload {out['reload_s']:.2f} s, "
          f"rollback {out['rollback_s']:.2f} s, at most {concurrent_swaps} swapping at once; "
          f"router trickle {json.dumps(stats)} beside one server's "
          f"{json.dumps(single_trickle)}; cache hit with no launch; capacity "
          f"{capacity['max_qps_fleet']} req/s [{smi}]", flush=True)
    return out


def phase_serve_control(torch, smi, device, tmp: Path, model_dir: Path) -> dict:
    """The coalescing invariant, hot-swap, HTTP, the SIGTERM drain and the
    fleet (module docstring, phase 6b)."""
    import os

    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    dirs = {"A": model_dir}
    t0 = time.perf_counter()
    for name, seed, nan_w in (("B", 1, False), ("NaN", 2, True)):
        dirs[name] = tmp / f"ctl_{name}"
        write_model_dir(torch, dirs[name], device, seed=seed, vocab=False, nan_w=nan_w)
    for name, seed in (("A", 3), ("B", 4)):
        write_code_vec(dirs[name] / "code.vec", seed)
    print(f"serve_control: dirs B and NaN and two code.vec written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ann_index = model_dir / "ann.index"
    out = {}
    try:
        # the check resets and reads the counts around each route itself
        out["coalescing"] = coalescing_check(torch, model_dir, device, smi)
        reset_launch_counts()
        out["hot_swap"] = ctl_hot_swap(torch, smi, device, dirs)
        out["http"] = ctl_http(torch, smi, device, dirs,
                               ann_index if ann_index.exists() else None)
        out["sigterm"] = ctl_sigterm(smi, device, dirs)
        out["fleet"] = ctl_fleet(smi, device, dirs, out["hot_swap"]["trickle"].get("before"))
    finally:
        os.environ.pop("C2V_HANDLE_DEBUG", None)
        (model_dir / "code.vec").unlink(missing_ok=True)
    counts = launch_counts()
    for launches in ([route["launches"] for route in out["coalescing"].values()]
                     + out["fleet"]["replica_launches"]):
        for key, n in launches.items():
            counts[key] = counts.get(key, 0) + n
    out["launches"] = counts
    print(f"serve_control launches (in process and the fleet's replicas): "
          f"{json.dumps(counts)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7: train
# ---------------------------------------------------------------------------

# route -> the launch keys its training run must show
TRAIN_ROUTES = {
    "plain": (),
    "pool_only": ("pool", "pool_bwd"),
    "gather_split": ("gather_split_masked",),
    "fused": ("fused_f32_masked",),
}


def train_corpus(n_methods=8192, mean_contexts=120.0, length_sigma=0.6, max_contexts=400):
    """A synthetic corpus at the top11 vocab and label widths, seed 0. The
    defaults are bench.py's training corpus (bench.py:3218-3229): 8,192
    methods, mean 120 contexts, max 400."""
    from code2vec_tpu_torch.data.synth import SynthSpec, corpus_data_from_raw, generate_corpus_data

    spec = SynthSpec(n_methods=n_methods, n_terminals=360_631, n_paths=342_845, n_labels=8_000,
                     mean_contexts=mean_contexts, length_sigma=length_sigma,
                     max_contexts=max_contexts, seed=0)
    raw = generate_corpus_data(spec)
    return raw, corpus_data_from_raw(raw)


def kernel_route(route):
    return dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}


def train_differential(torch, dev, data, config, host_batches, routes) -> dict:
    """From one set of seeded weights, dropout 0, the same batches: each
    kernel route's (config updates in ``routes``, the first the plain
    route) losses within rtol 1e-4 of the plain route's and its gradients
    (taken before each optimizer step) within atol 1e-5 / rtol 1e-3 of the
    plain route's. TF32 is off, so the plain route is f32. Under bf16
    compute bf16 rounds at other places on each route (the plain pool's
    code vector is bf16, K1 pools in f32, K2-K4 recompute the plain bf16
    forward): every batch's gradients are taken from the seeded weights (a
    step would carry one route's rounding into the next batch's weights),
    losses within rtol 2^-7 and gradients within 2^-5 of each tensor's
    largest element. Under ``table_update="lazy"`` the tables' gradients are
    the per-slot ones (``<table> slots``), and each step must leave the rows
    it does not touch, and their moments, bit for bit as they were."""
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.loop import class_weights_from, model_config_from
    from code2vec_tpu_torch.train.step import (
        forward_backward,
        lazy_forward_backward,
        make_optimizer,
        to_device,
    )
    from code2vec_tpu_torch.train.table_opt import TABLE_PARAMS

    batches = [to_device(b, dev) for b in host_batches]
    weights = class_weights_from(config, data, dev)
    base_cfg = model_config_from(config.with_updates(dropout_prob=0.0), data)
    base = Code2Vec(base_cfg)
    base.reset_parameters(torch.Generator().manual_seed(5))
    state = {k: v.to(dev) for k, v in base.state_dict().items()}
    bf16 = config.compute_dtype == "bfloat16"
    loss_rtol, grad_rtol, grad_atol, grad_frac = (2.0**-7, 0.0, 0.0, 2.0**-5) if bf16 else \
        (1e-4, 1e-3, 1e-5, 0.0)
    lazy = config.table_update == "lazy"
    ref, out = None, {}
    for route, kernel in routes.items():
        with torch.device(dev):
            model = Code2Vec(base_cfg.with_updates(**kernel))
        model.load_state_dict(state)
        opt = make_optimizer(model, config)
        tables = [model.get_parameter(name) for name in TABLE_PARAMS]
        steps = []
        for batch in batches:
            opt.zero_grad(set_to_none=True)
            if not lazy:
                loss = forward_backward(model, batch, weights)
                steps.append((loss, {k: p.grad.clone() for k, p in model.named_parameters()}))
                if not bf16:
                    opt.step()
                continue
            loss, table_grads = lazy_forward_backward(model, batch, weights)
            grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
            grads.update({f"{name} slots": s.clone()
                          for name, (_, s) in zip(TABLE_PARAMS, table_grads)})
            steps.append((loss, grads))
            if any(t.grad is not None for t in tables):
                raise AssertionError(f"lazy {route}: a table got a dense .grad")
            before = [(t.detach().clone(), opt.state[t]["exp_avg"].clone(),
                       opt.state[t]["exp_avg_sq"].clone()) for t in tables]
            opt.step(table_grads)
            for t, prev, (ids, _) in zip(tables, before, table_grads):
                untouched = torch.ones(t.shape[0], dtype=torch.bool, device=dev)
                untouched[ids.long()] = False
                now = (t.detach(), opt.state[t]["exp_avg"], opt.state[t]["exp_avg_sq"])
                if not all(torch.equal(a[untouched], b[untouched]) for a, b in zip(now, prev)):
                    raise AssertionError(f"lazy {route}: an untouched row or moment changed")
            del before
        if ref is None:
            ref = steps
            out[route] = [float(loss) for loss, _ in steps]
            continue
        worst = 0.0
        for (loss, grads), (ref_loss, ref_grads) in zip(steps, ref):
            torch.testing.assert_close(loss, ref_loss, rtol=loss_rtol, atol=0)
            for k, g in ref_grads.items():
                atol = grad_atol + grad_frac * g.abs().max().item()
                torch.testing.assert_close(grads[k], g, rtol=grad_rtol, atol=atol, msg=k)
                worst = max(worst, (grads[k] - g).abs().max().item())
        out[route] = {"losses": [float(loss) for loss, _ in steps], "max_abs_grad_err": worst}
        print(f"train differential {'lazy ' if lazy else ''}{route}: {len(steps)} steps at widths "
              f"{[b['starts'].shape[1] for b in host_batches]}, losses "
              f"{[round(x, 6) for x in out[route]['losses']]} vs plain "
              f"{[round(x, 6) for x in out['plain']]}, max |grad - plain| {worst:.3e}",
              flush=True)
        del model, opt, steps
    return out


def profile_steps(torch, model, opt, batches, weights, top=8) -> list:
    """The ops with the most device time over ``batches`` train steps
    (``torch.profiler``), in ms per step."""
    from torch.profiler import ProfilerActivity, profile

    from code2vec_tpu_torch.train.step import train_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            train_step(model, opt, batch, weights)
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    ops = sorted(prof.key_averages(), key=device_us, reverse=True)[:top]
    return [(e.key[:60], device_us(e) / 1e3 / len(batches)) for e in ops]


def step_breakdown(torch, dev, data, config, smi, label="", routes=None) -> dict:
    """Where a train step's time goes, per route (dropout 0.25; every
    route of the train phase unless ``routes`` names some): device ms
    of the forward, the backward and the optimizer step (CUDA events), the
    host's wall ms of a whole step (synchronised), and the host's ms to
    build an epoch and to slice + pin + copy one batch. Median of 5 steps
    after 2 warm ones. Under ``table_update="lazy"`` the forward takes the
    zero offsets, the optimizer span begins with collecting the per-slot
    gradients, and the mean number of distinct rows a step touches in each
    table is reported."""
    from code2vec_tpu_torch.data.pipeline import build_epoch, iter_batches
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.loop import class_weights_from, model_config_from
    from code2vec_tpu_torch.train.step import (
        make_optimizer,
        slot_grads,
        to_device,
        weighted_nll,
        zero_offsets,
    )

    rng = np.random.default_rng(2)
    items = rng.permutation(data.n_items)[:7 * TRAIN_BATCH]
    t0 = time.perf_counter()
    epoch = build_epoch(data, items, config.max_path_length, rng,
                        config.shuffle_variable_indexes)
    build_ms = (time.perf_counter() - t0) * 1e3
    host_batches = list(iter_batches(epoch, TRAIN_BATCH, rng=rng))
    t0 = time.perf_counter()
    batches = [to_device(b, dev) for b in host_batches]
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    weights = class_weights_from(config, data, dev)
    out = {"epoch_build_ms_7_batches": build_ms, "batch_copy_ms": feed_ms}
    lazy = config.table_update == "lazy"
    if lazy:
        out["touched_rows_per_step"] = {
            "terminal": float(np.mean([np.unique(np.concatenate([b["starts"], b["ends"]], 1)).size
                                       for b in host_batches])),
            "path": float(np.mean([np.unique(b["paths"]).size for b in host_batches])),
        }
        print(f"lazy steps touch {out['touched_rows_per_step']['terminal']:.1f} of "
              f"{len(data.terminal_vocab)} terminal rows and "
              f"{out['touched_rows_per_step']['path']:.1f} of {len(data.path_vocab)} path rows "
              f"a step (mean) [{smi}]", flush=True)
    for route in routes or TRAIN_ROUTES:
        with torch.device(dev):
            model = Code2Vec(model_config_from(config.with_updates(**kernel_route(route)), data))
        model.seed_dropout(0)
        model.train()
        opt = make_optimizer(model, config)
        rows = []
        for i, batch in enumerate(batches):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            opt.zero_grad(set_to_none=True)
            offsets = zero_offsets(model.config, batch["starts"].shape, dev) if lazy else None
            logits, _, _ = model(batch["starts"], batch["paths"], batch["ends"],
                                 embed_offsets=offsets)
            loss = weighted_nll(logits, batch["labels"], weights, batch["example_mask"])
            ev[1].record()
            loss.backward()
            ev[2].record()
            if lazy:
                opt.step(slot_grads(batch, offsets))
            else:
                opt.step()
            ev[3].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if i >= 2:
                rows.append([ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                             ev[2].elapsed_time(ev[3]), wall])
        med = np.median(np.asarray(rows), axis=0).tolist()
        out[route] = dict(zip(("forward_ms", "backward_ms", "optimizer_ms", "step_wall_ms"),
                              med))
        out[route]["top_ops"] = profile_steps(torch, model, opt, batches[2:4], weights)
        print(f"train step breakdown {label}{route}: forward {med[0]:.3f} ms, backward {med[1]:.3f} "
              f"ms, optimizer {med[2]:.3f} ms (device, events), whole step {med[3]:.3f} ms "
              f"(host wall, synchronised); host: epoch build {build_ms:.1f} ms for "
              f"{len(items)} methods ({len(epoch)} rows), batch slice+pin+copy {feed_ms:.3f} ms "
              f"[{smi}]", flush=True)
        print("  device ms per step by op: " + "; ".join(
            f"{name} {ms:.3f}" for name, ms in out[route]["top_ops"]), flush=True)
        del model, opt
    return out


def train_route(torch, smi, dev, data, config, label, keys, out_dir=None,
                vectors_path=None) -> dict:
    """``train()`` on one route for ``config.max_epoch`` epochs, the launch
    counts set to 0 just before and read just after: the epochs' metrics,
    the counts, the wall seconds and the peak device memory. Fails on a
    non-finite loss or a kernel of ``keys`` never launched (the plain route
    must launch none)."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.train.loop import train

    epochs = []

    def report(m):
        epochs.append(m)
        pad = (f", pad_efficiency {m['pad_efficiency']:.4f}" if "pad_efficiency" in m else "")
        if "truncated_context_fraction" in m:  # the method rows' geometry
            pad += f", truncated_context_fraction {m['truncated_context_fraction']:.4f}"
        print(f"train {label} epoch {m['epoch']}: loss {m['train_loss']:.6f} test_loss "
              f"{m['test_loss']:.6f} subtoken f1 {m['f1']:.6f}, {m['train_steps']} steps, "
              f"{m['steps_per_s']:.3f} steps/s, {m['contexts_per_s']:.1f} contexts/s "
              f"(train steps after the warm one), epoch_seconds {m['epoch_seconds']:.4f}{pad} "
              f"[{smi}]", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train(config, data, out_dir, vectors_path, device=dev, on_epoch=report)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(m["train_loss"]) and math.isfinite(m["test_loss"])
               for m in epochs) or len(epochs) != config.max_epoch:
        raise AssertionError(f"train {label}: epochs {epochs}")
    missing = [k for k in keys if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"train {label} never launched {missing}: {counts}")
    if not config.use_pallas and counts:
        raise AssertionError(f"the plain route launched kernels: {counts}")
    print(f"train {label}: {len(epochs)} epochs in {seconds:.1f}s, peak device memory "
          f"{peak / 2**30:.3f} GiB, launches {counts} [{smi}]", flush=True)
    del result
    torch.cuda.empty_cache()
    return {"epochs": epochs, "launches": counts, "seconds": seconds, "peak_bytes": peak}


def phase_train(torch, smi, dev, tmp: Path) -> dict:
    """Train code2vec at the top11 widths through each route: 2 epochs of
    batch 1024 at bag 200, dropout 0.25; then the differential and serving
    the fused route's model dir."""
    from code2vec_tpu_torch.data.pipeline import build_method_epoch, iter_batches
    from code2vec_tpu_torch.formats.vocab_io import read_vocab, write_vocab_from_names
    from code2vec_tpu_torch.train.config import TrainConfig

    t0 = time.perf_counter()
    raw, data = train_corpus()
    print(f"train corpus: {data.n_items} methods, {data.n_contexts} contexts, "
          f"{len(data.terminal_vocab)} terminals, {len(data.path_vocab)} paths, "
          f"{len(data.label_vocab)} labels, made in {time.perf_counter() - t0:.1f}s", flush=True)
    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                         max_epoch=2, random_seed=0, print_sample_cycle=0)
    out = {"routes": {}}
    model_dir = tmp / "trained_fused"
    for route, keys in TRAIN_ROUTES.items():
        out["routes"][route] = train_route(
            torch, smi, dev, data, config.with_updates(**kernel_route(route)), route, keys,
            str(model_dir) if route == "fused" else None)
    rng = np.random.default_rng(1)
    items = rng.permutation(data.n_items)[:3 * TRAIN_BATCH]
    epoch = build_method_epoch(data, items, config.max_path_length, rng)
    out["differential"] = train_differential(
        torch, dev, data, config, list(iter_batches(epoch, TRAIN_BATCH)),
        {route: kernel_route(route) for route in TRAIN_ROUTES})
    out["breakdown"] = step_breakdown(torch, dev, data, config, smi)

    # the fused run's dir, served as it stands (plus the vocab files a
    # server reads)
    write_vocab_from_names(model_dir / "terminal_idxs.txt", raw.terminal_names)
    write_vocab_from_names(model_dir / "path_idxs.txt", raw.path_names)
    meta = json.loads((model_dir / "model_meta.json").read_text())
    if len(read_vocab(model_dir / "label_vocab.txt")) != meta["label_count"]:
        raise AssertionError("the trained dir's label vocab disagrees with its meta")
    requests = make_requests(16, seed=23)
    for req in requests:
        req["op"] = "predict"
    served = serve_route(torch, model_dir, "fused", "f32", requests, smi, dev,
                         ladder=tuple(meta["bucket_ladder"]))
    if served["launches"].get("fused_f32", 0) < 1:
        raise AssertionError("serving the trained dir never launched K3")
    out["served"] = served
    return out


# ---------------------------------------------------------------------------
# phase 7b: elastic training (mid-epoch saves, async saves, kill / SIGTERM
# and resume)
# ---------------------------------------------------------------------------

# what an epoch line carries beside its metrics, left out of the bitwise
# comparisons: the clocks and speeds, the steps of the pass that ran (a
# resumed epoch's tail), its replay of the cursor, and a device run's
# staging (in the first epoch each run completes)
ELASTIC_CLOCKS = ("epoch_seconds", "steps_per_s", "contexts_per_s", "train_steps",
                  "replayed_batches", "replay_seconds", "stage_seconds", "staged_bytes")
# route -> the kernels its training and its eval launch
ELASTIC_KEYS = {"fused": ("fused_f32_masked", "fused_f32"), "pool_only": ("pool", "pool_bwd")}


def write_raw_corpus(raw, root: Path) -> dict:
    """``raw`` (the train phase's corpus) as ``corpus.txt`` with its vocab
    files and no aliases: the corpus a CLI run reads."""
    from code2vec_tpu_torch.formats.corpus_io import CorpusRecord, write_corpus_record
    from code2vec_tpu_torch.formats.vocab_io import write_vocab_from_names

    root.mkdir(parents=True, exist_ok=True)
    paths = {"corpus": root / "corpus.txt", "path_idx": root / "path_idxs.txt",
             "terminal_idx": root / "terminal_idxs.txt"}
    with open(paths["corpus"], "w", encoding="utf-8") as f:
        for i in range(len(raw.row_splits) - 1):
            lo, hi = raw.row_splits[i], raw.row_splits[i + 1]
            write_corpus_record(f, CorpusRecord(
                id=i + 1, label=raw.label_names[raw.label_ids[i]],
                path_contexts=list(zip(raw.starts[lo:hi].tolist(), raw.paths[lo:hi].tolist(),
                                       raw.ends[lo:hi].tolist()))))
    write_vocab_from_names(paths["terminal_idx"], raw.terminal_names)
    write_vocab_from_names(paths["path_idx"], raw.path_names)
    return {k: str(v) for k, v in paths.items()}


def same_history(label, got, want):
    """Every metric of every epoch bitwise the uninterrupted run's, but the
    clocks (``ELASTIC_CLOCKS``)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} epochs vs the uninterrupted {len(want)}")
    for g, w in zip(got, want):
        keys = sorted((set(g) | set(w)) - set(ELASTIC_CLOCKS))
        diff = [(k, g.get(k), w.get(k)) for k in keys if g.get(k) != w.get(k)]
        if diff:
            raise AssertionError(f"{label}: epoch {w['epoch']} differs from the uninterrupted "
                                 f"run in {diff}")


def same_weights(torch, label, got: dict, want: dict):
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    if diff or got.keys() != want.keys():
        raise AssertionError(f"{label}: the final weights differ from the uninterrupted run's "
                             f"in {diff}")


def elastic_run(torch, smi, dev, data, config, label, keys, out_dir: Path) -> dict:
    """``train()`` once into ``out_dir``, the launch counts set to 0 just
    before and read just after. A ``raise`` plan must raise its
    ``FaultInjected`` (caught here only then); any other run must return.
    Each of ``keys`` must have been launched. After a SIGTERM the seconds
    from the request to the return are kept."""
    from code2vec_tpu_torch import faultinject
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.train.loop import train
    from code2vec_tpu_torch.train.preempt import preemption_guard

    epochs = []
    expect_raise = ":raise" in config.fault_plan
    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = None
    try:
        result = train(config, data, str(out_dir), device=dev, on_epoch=epochs.append)
    except faultinject.FaultInjected:
        if not expect_raise:
            raise
    else:
        if expect_raise:
            raise AssertionError(f"elastic {label}: the plan {config.fault_plan} never fired")
    end = time.perf_counter()
    guard = preemption_guard()
    counts = launch_counts()
    missing = [k for k in keys if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"elastic {label} never launched {missing}: {counts}")
    if not all(math.isfinite(m["train_loss"]) for m in epochs):
        raise AssertionError(f"elastic {label}: epochs {epochs}")
    for m in epochs:
        replay = (f", replayed {m['replayed_batches']} batches in {m['replay_seconds']:.4f} s"
                  if "replayed_batches" in m else "")
        print(f"elastic {label} epoch {m['epoch']}: loss {m['train_loss']:.6f} test_loss "
              f"{m['test_loss']:.6f} f1 {m['f1']:.6f}, {m['train_steps']} steps, "
              f"epoch_seconds {m['epoch_seconds']:.4f}{replay} [{smi}]", flush=True)
    saves = result.checkpoint_saves if result is not None else []
    for s in saves:
        print(f"elastic {label}: save {s['slot']} at step {s['step']} "
              f"({'async' if s['async'] else 'sync'}): blocking {s['blocking_ms']:.2f} ms, "
              f"persist {s.get('persist_s', float('nan')):.3f} s [{smi}]", flush=True)
    print(f"elastic {label}: {len(epochs)} epochs in {end - t0:.1f}s, launches {counts} "
          f"[{smi}]", flush=True)
    return {"result": result, "epochs": epochs, "launches": counts, "seconds": end - t0,
            "saves": saves,
            "sigterm_to_return": end - guard.requested_at if guard.requested() else None}


def slot_cursor(torch, out_dir: Path) -> dict:
    from code2vec_tpu_torch.checkpoint import slot_path

    return torch.load(slot_path(str(out_dir), "last"), map_location="cpu", weights_only=False,
                      mmap=True)["meta"]["cursor"]


def phase_train_elastic(torch, smi, dev, tmp: Path) -> dict:
    """Elastic training at the train phase's recipe (top11 widths, 8,192
    methods, batch 1024, bag 200, dropout 0.25, 7 steps an epoch, 2
    epochs), the corpus written as text and loaded as the CLI loads it:
    (a) fused uninterrupted with no mid-epoch save, with a save every 3
    steps, and the same async: the histories and weights bitwise equal; the
    checkpoint's bytes, each save's blocking ms, the persist seconds and
    epoch_seconds; (b) a raise at step 11 (epoch 1's 4th, after its step-3
    save) and --resume: bitwise (a)'s; (c) pool_only prefetched, SIGTERM at
    step 9: train() returns, the cursor at epoch 1 step 2, the seconds from
    the signal to the return, the resume bitwise an uninterrupted pool_only
    run; (d) the CLI in a subprocess killed at step 11 (exit -9) and
    resumed (exit 0): (a)'s history; (e) device epochs, SIGTERM at the
    second epoch_start: a boundary save and its resume bitwise an
    uninterrupted device run."""
    import os
    import shutil

    from code2vec_tpu_torch.checkpoint import slot_path
    from code2vec_tpu_torch.data.pipeline import split_items
    from code2vec_tpu_torch.data.reader import load_corpus
    from code2vec_tpu_torch.train.config import TrainConfig

    raw, _ = train_corpus()
    root = tmp / "elastic"
    t0 = time.perf_counter()
    paths = write_raw_corpus(raw, root / "corpus")
    data = load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"], cache=False)
    print(f"elastic corpus: {data.n_items} methods written and loaded in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                         max_epoch=2, random_seed=0, print_sample_cycle=0)
    train_idx, _ = split_items(data.n_items, np.random.default_rng(config.random_seed))
    steps = -(-len(train_idx) // TRAIN_BATCH)
    if steps != 7:
        raise AssertionError(f"elastic: {steps} train steps an epoch, the plans assume 7")
    fused = config.with_updates(**kernel_route("fused"))
    out, runs = {"steps_per_epoch": steps}, []

    def run(label, cfg, keys, name):
        r = elastic_run(torch, smi, dev, data, cfg, label, keys, root / name)
        runs.append(r["launches"])
        return r

    # (a) three uninterrupted runs
    none = run("fused (a) no mid-epoch save", fused, ELASTIC_KEYS["fused"], "a_none")
    sync = run("fused (a) sync every 3", fused.with_updates(checkpoint_every_steps=3),
               ELASTIC_KEYS["fused"], "a_sync")
    asyn = run("fused (a) async every 3",
               fused.with_updates(checkpoint_every_steps=3, async_checkpoint=True),
               ELASTIC_KEYS["fused"], "a_async")
    ckpt_bytes = os.path.getsize(slot_path(str(root / "a_sync"), "best"))
    ref_history = sync["result"].history
    ref_weights = {k: v.clone() for k, v in sync["result"].model.state_dict().items()}
    for name, r in (("no mid-epoch save", none), ("async", asyn)):
        same_history(f"fused (a) {name}", r["result"].history, ref_history)
        same_weights(torch, f"fused (a) {name}", r["result"].model.state_dict(), ref_weights)
    mid = {name: [s for s in r["saves"] if s["slot"] == "last"]
           for name, r in (("sync", sync), ("async", asyn))}
    if [len(v) for v in mid.values()] != [4, 4] or not all(s["async"] for s in mid["async"]):
        raise AssertionError(f"elastic (a): mid-epoch saves {mid}")
    out["a"] = {"checkpoint_bytes": ckpt_bytes,
                "epoch_seconds": {name: [m["epoch_seconds"] for m in r["epochs"]]
                                  for name, r in (("none", none), ("sync", sync),
                                                  ("async", asyn))},
                "saves": {"sync": sync["saves"], "async": asyn["saves"]}}
    print(f"elastic (a): checkpoint {ckpt_bytes} bytes; mid-epoch saves' blocking ms sync "
          f"{[round(s['blocking_ms'], 2) for s in mid['sync']]} / async (the snapshot) "
          f"{[round(s['blocking_ms'], 2) for s in mid['async']]}; persist s sync "
          f"{[round(s['persist_s'], 3) for s in mid['sync']]} / async "
          f"{[round(s['persist_s'], 3) for s in mid['async']]}; epoch_seconds: no mid-epoch "
          f"save {out['a']['epoch_seconds']['none']}, sync every 3 "
          f"{out['a']['epoch_seconds']['sync']}, async every 3 "
          f"{out['a']['epoch_seconds']['async']}; the three histories and final weights "
          f"bitwise equal [{smi}]", flush=True)
    for name in ("a_none", "a_sync", "a_async"):
        shutil.rmtree(root / name)
    del none, sync, asyn

    # (b) a raise at step 11, then --resume
    every3 = fused.with_updates(checkpoint_every_steps=3)
    run("fused (b) raise at step 11", every3.with_updates(fault_plan="train_step@11:raise"),
        ELASTIC_KEYS["fused"][:1], "b")
    cursor = slot_cursor(torch, root / "b")
    if (cursor["epoch"], cursor["step"]) != (1, 3):
        raise AssertionError(f"elastic (b): the slot's cursor {cursor['epoch'], cursor['step']}")
    resumed = run("fused (b) resumed", every3.with_updates(resume=True), ELASTIC_KEYS["fused"],
                  "b")
    same_history("fused (b)", resumed["result"].history, ref_history)
    same_weights(torch, "fused (b)", resumed["result"].model.state_dict(), ref_weights)
    replay = resumed["result"].history[1]
    out["b"] = {"replayed_batches": replay["replayed_batches"],
                "replay_seconds": replay["replay_seconds"]}
    print(f"elastic (b): the resume bitwise (a)'s; replayed {replay['replayed_batches']} "
          f"batches in {replay['replay_seconds']:.4f} s [{smi}]", flush=True)
    shutil.rmtree(root / "b")
    del resumed

    # (c) pool_only prefetched: SIGTERM at step 9, then --resume
    pool = config.with_updates(**kernel_route("pool_only"), prefetch_batches=2)
    whole = run("pool_only (c) uninterrupted", pool, ELASTIC_KEYS["pool_only"], "c_whole")
    pre = run("pool_only (c) SIGTERM at step 9",
              pool.with_updates(fault_plan="train_step@9:sigterm"), ELASTIC_KEYS["pool_only"],
              "c")
    cursor = slot_cursor(torch, root / "c")
    if (pre["result"].epochs_run, cursor["epoch"], cursor["step"]) != (1, 1, 2) \
            or pre["sigterm_to_return"] is None:
        raise AssertionError(f"elastic (c): {pre['result'].epochs_run} epochs, cursor "
                             f"{cursor['epoch'], cursor['step']}")
    resumed = run("pool_only (c) resumed", pool.with_updates(resume=True),
                  ELASTIC_KEYS["pool_only"], "c")
    same_history("pool_only (c)", resumed["result"].history, whole["result"].history)
    same_weights(torch, "pool_only (c)", resumed["result"].model.state_dict(),
                 whole["result"].model.state_dict())
    out["c"] = {"sigterm_to_return_seconds": pre["sigterm_to_return"]}
    print(f"elastic (c): SIGTERM to train()'s return {pre['sigterm_to_return']:.3f} s (the "
          f"step in flight, the cursor's save, the producer joined); the resume bitwise the "
          f"uninterrupted run's [{smi}]", flush=True)
    for name in ("c", "c_whole"):
        shutil.rmtree(root / name)
    del whole, pre, resumed

    # (d) the CLI in a subprocess: SIGKILL at step 11, then --resume
    cli_dir = root / "d"
    argv = [sys.executable, "-m", "code2vec_tpu_torch", "--corpus_path", paths["corpus"],
            "--path_idx_path", paths["path_idx"], "--terminal_idx_path", paths["terminal_idx"],
            "--model_path", str(cli_dir), "--vectors_path", str(cli_dir / "code.vec"),
            "--no_corpus_cache", "--terminal_embed_size", "100", "--path_embed_size", "100",
            "--encode_size", "100", "--max_path_length", str(BAG), "--batch_size",
            str(TRAIN_BATCH), "--dropout_prob", "0.25", "--max_epoch", "2", "--random_seed",
            "0", "--print_sample_cycle", "0", "--use_pallas", "--pallas_impl", "fused",
            "--checkpoint_every_steps", "3"]
    env = {k: v for k, v in os.environ.items() if k != "C2V_FAULT_PLAN"}
    lines, codes, secs = [], [], []
    for extra in (["--fault_plan", "train_step@11:kill"], ["--resume"]):
        t0 = time.perf_counter()
        proc = subprocess.run(argv + extra, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=300)
        secs.append(time.perf_counter() - t0)
        codes.append(proc.returncode)
        lines += [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        if proc.returncode not in (-9, 0) or (extra[0] == "--resume") != (proc.returncode == 0):
            raise AssertionError(f"elastic (d) {extra}: exit {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    same_history("the CLI (d)", lines, ref_history)
    out["d"] = {"exit_codes": codes, "seconds": secs}
    print(f"elastic (d): the CLI exited {codes[0]} at step 11 ({secs[0]:.1f} s) and {codes[1]} "
          f"resumed ({secs[1]:.1f} s, replayed {lines[1].get('replayed_batches')} batches); "
          f"its history bitwise (a)'s [{smi}]", flush=True)
    shutil.rmtree(cli_dir)

    # (e) device epochs: SIGTERM at the second epoch_start, then --resume
    device = fused.with_updates(device_epoch=True)
    whole = run("fused (e) device epochs", device, ELASTIC_KEYS["fused"], "e_whole")
    pre = run("fused (e) device epochs, SIGTERM at epoch_start 2",
              device.with_updates(fault_plan="epoch_start@2:sigterm"), ELASTIC_KEYS["fused"],
              "e")
    cursor = slot_cursor(torch, root / "e")
    if (pre["result"].epochs_run, cursor["epoch"], cursor["step"]) != (1, 1, 0):
        raise AssertionError(f"elastic (e): {pre['result'].epochs_run} epochs, cursor "
                             f"{cursor['epoch'], cursor['step']}")
    resumed = run("fused (e) device epochs resumed", device.with_updates(resume=True),
                  ELASTIC_KEYS["fused"], "e")
    same_history("fused (e)", resumed["result"].history, whole["result"].history)
    same_weights(torch, "fused (e)", resumed["result"].model.state_dict(),
                 whole["result"].model.state_dict())
    out["e"] = {"sigterm_to_return_seconds": pre["sigterm_to_return"]}
    print(f"elastic (e): a boundary save at SIGTERM ({pre['sigterm_to_return']:.3f} s to the "
          f"return); the resume bitwise the uninterrupted device run's [{smi}]", flush=True)
    del whole, pre, resumed
    for child in root.iterdir():
        if child.name != "corpus":  # the corpus stays for train_hpo
            shutil.rmtree(child)
    out["corpus_paths"] = paths
    out["launches"] = {}
    for counts in runs:
        for key, n in counts.items():
            out["launches"][key] = out["launches"].get(key, 0) + n
    print(f"train_elastic launches: {json.dumps(out['launches'])}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7c: train_hpo — the search, the metric sinks, the telemetry, the projector
# ---------------------------------------------------------------------------

# the search's encode widths on the card: the last W-resident width of K2-K4
# (104), the first streamed one (105), H % 4 != 0 (K1/K1b's scalar path:
# 105, 173, 257) and both sides of K1b's register cap (256, 257), up to 300
HPO_WIDTHS = (104, 105, 173, 256, 257, 300)
HPO_KEEPS = (0.5, 0.9)
HPO_SHAPE = (256, BAG)
HPO_TRIALS = 4
HPO_MEMORY_SLACK = 64 * 2**20  # bytes: memory after the last trial vs after the first
# the train differential's bar on the VJP (train_differential)
VJP_RTOL, VJP_ATOL = 1e-3, 1e-5


def hpo_kernels(torch, dev, smi) -> dict:
    """(a) K3 masked forward and its VJP, K1 and K1b at B = 256, L = 200
    and each width of ``HPO_WIDTHS`` (keep 0.5 and 0.9 for K3), each held
    against its plain version: forwards within ``TOL``, K1b's d_ctx within
    ``TOL`` and d_attn within rtol 1e-4, the VJP within the train
    differential's bar. K3 masked and K1 are timed at each width."""
    from code2vec_tpu_torch.ops.attention import attention_pool, pool_backward_reference
    from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool, reference_forward
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel, pool_backward_kernel

    c = TOP11
    B, L = HPO_SHAPE
    D = 2 * c["terminal_embed_size"] + c["path_embed_size"]
    g = torch.Generator(device=dev).manual_seed(4242)
    bench = KernelBench(torch, dev)
    T = torch.randn(c["terminal_count"], c["terminal_embed_size"], generator=g, device=dev)
    P = torch.randn(c["path_count"], c["path_embed_size"], generator=g, device=dev)
    rows = []
    for H in HPO_WIDTHS:
        W = torch.randn(D, H, generator=g, device=dev) / math.sqrt(D)
        lns = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
        lnb = 0.1 * torch.randn(H, generator=g, device=dev)
        attn = 0.08 * torch.randn(H, generator=g, device=dev)
        s, p, e, mask = id_inputs(torch, dev, g, B, L)
        row = {"H": H, "B": B, "L": L}
        for keep in HPO_KEEPS:
            drop = torch.empty(B, L, H, device=dev).bernoulli_(keep, generator=g) / keep
            margs = (T, P, s, p, e, mask)
            cv, w = fused_encode_attend_pool(*margs, W, lns, lnb, attn, drop, impl="fused")
            cv_ref, w_ref = reference_forward(*margs, W, lns, lnb, attn, drop)
            torch.testing.assert_close(cv, cv_ref, rtol=TOL, atol=TOL,
                                       msg=lambda m: f"K3 masked H={H} keep={keep}: {m}")
            torch.testing.assert_close(w, w_ref, rtol=TOL, atol=TOL,
                                       msg=lambda m: f"K3 masked H={H} keep={keep}: {m}")
            # the VJP: K3's forward, then the op's backward, against autograd
            # of the plain forward from the same parameters
            g_cv = torch.randn(B, H, generator=g, device=dev)
            g_w = torch.randn(B, L, generator=g, device=dev)
            grads = []
            for fn in (lambda *a: fused_encode_attend_pool(*margs, *a, drop, impl="fused"),
                       lambda *a: reference_forward(*margs, *a, drop)):
                leaves = [x.clone().requires_grad_() for x in (W, lns, lnb, attn)]
                out_cv, out_w = fn(*leaves)
                grads.append(torch.autograd.grad((out_cv, out_w), leaves, (g_cv, g_w)))
            worst = 0.0
            for name, got, want in zip(("W", "ln_scale", "ln_bias", "attn"), *grads):
                torch.testing.assert_close(got, want, rtol=VJP_RTOL, atol=VJP_ATOL,
                                           msg=lambda m: f"K3 VJP {name} H={H}: {m}")
                worst = max(worst, (got - want).abs().max().item())
            row[f"k3_masked_err_keep{keep}"] = max((cv - cv_ref).abs().max().item(),
                                                   (w - w_ref).abs().max().item())
            row[f"k3_vjp_err_keep{keep}"] = worst
            if keep == HPO_KEEPS[0]:
                row["k3_masked_ms"] = bench.time_ms(lambda: fused_encode_attend_pool(
                    *margs, W, lns, lnb, attn, drop, impl="fused"))
                row["k3_masked_plain_ms"] = bench.time_ms(
                    lambda: reference_forward(*margs, W, lns, lnb, attn, drop))
                nbytes, _, ops_s = encode_pool_bound(torch, s, p, e, mask, "f32", H)
                row["k3_masked_bound_ms"] = bound_of(nbytes + 4 * B * L * H, ops_s)[0] * 1e3
            del drop
        ctx, cmask, a = pool_inputs(torch, dev, g, B, L, H)
        cv, w = attention_pool_kernel(ctx, cmask, a)
        cv_ref, w_ref = attention_pool(ctx, cmask, a)
        torch.testing.assert_close(cv, cv_ref, rtol=TOL, atol=TOL, msg=f"K1 H={H}")
        torch.testing.assert_close(w, w_ref, rtol=TOL, atol=TOL, msg=f"K1 H={H}")
        g_cv = torch.randn(B, H, generator=g, device=dev)
        g_w = torch.randn(B, L, generator=g, device=dev)
        d_ctx, d_attn = pool_backward_kernel(ctx, cmask, a, w_ref, cv_ref, g_cv, g_w)
        d_ctx_ref, d_attn_ref = pool_backward_reference(ctx, cmask, a, w_ref, g_cv, g_w)
        torch.testing.assert_close(d_ctx, d_ctx_ref, rtol=0, atol=TOL, msg=f"K1b d_ctx H={H}")
        torch.testing.assert_close(d_attn, d_attn_ref, rtol=1e-4, atol=TOL,
                                   msg=f"K1b d_attn H={H}")
        row.update(
            k1_err=max((cv - cv_ref).abs().max().item(), (w - w_ref).abs().max().item()),
            k1b_err=max((d_ctx - d_ctx_ref).abs().max().item(),
                        (d_attn - d_attn_ref).abs().max().item()),
            k1_ms=bench.time_ms(lambda: attention_pool_kernel(ctx, cmask, a)),
            k1b_ms=bench.time_ms(lambda: pool_backward_kernel(ctx, cmask, a, w_ref, cv_ref,
                                                              g_cv, g_w)),
            k1_bound_ms=bound_of(pool_bound(B, L, H)[0], 0.0)[0] * 1e3,
            k1b_bound_ms=bound_of(pool_bwd_bound(B, L, H)[0], 0.0)[0] * 1e3)
        rows.append(row)
        print(f"hpo (a) H={H}: K3 masked err {row['k3_masked_err_keep0.5']:.2e} / "
              f"{row['k3_masked_err_keep0.9']:.2e} (keep 0.5 / 0.9), VJP err "
              f"{row['k3_vjp_err_keep0.5']:.2e} / {row['k3_vjp_err_keep0.9']:.2e}, "
              f"ms={row['k3_masked_ms']:.4f} plain_ms={row['k3_masked_plain_ms']:.4f} "
              f"bound_ms={row['k3_masked_bound_ms']:.4f}; K1 err {row['k1_err']:.2e} "
              f"ms={row['k1_ms']:.4f} bound_ms={row['k1_bound_ms']:.4f}; K1b err "
              f"{row['k1b_err']:.2e} ms={row['k1b_ms']:.4f} bound_ms={row['k1b_bound_ms']:.4f} "
              f"[{smi}]", flush=True)
        del ctx, cmask, a, W
    del T, P, bench
    torch.cuda.empty_cache()
    return {"rows": rows}


def hpo_search(torch, smi, dev, data) -> dict:
    """(b) ``find_optimal_hyperparams`` through the API on the train
    phase's corpus at the top11 widths: 4 trials of 2 epochs on fused, TPE
    after 2 startup trials, median pruning after 1. Per trial its params,
    state, value, warm epoch_seconds, its launches (counts reset at its
    ``trial`` event, read at its ``trial_result``) and ``memory_allocated``
    after it. Every trial must launch K3 masked, no loss may be
    non-finite, no checkpoint or vectors may be written, and the memory
    after the last trial within 64 MiB of that after the first. Then the
    space's two corners, run as a trial runs: encode 100 at batch 1024 and
    encode 300 at batch 2048, their epoch_seconds."""
    from code2vec_tpu_torch.hpo import MedianPruner, TPESampler, find_optimal_hyperparams
    from code2vec_tpu_torch.obs.events import EventLog
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import release_device_memory, train

    base = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                       max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                       max_epoch=2, random_seed=0, print_sample_cycle=0, **kernel_route("fused"))
    trials, bad = [], []
    events = EventLog()

    def watch(event):
        kind = event["event"]
        if kind == "trial":
            reset_launch_counts()
            trials.append({"number": event["number"], "params": event["params"], "epochs": []})
        elif kind == "epoch" and trials:
            trials[-1]["epochs"].append(event["metrics"])
        elif kind == "checkpoint_saved":
            bad.append(f"a trial saved a checkpoint: {event}")
        elif kind == "trial_result":
            torch.cuda.synchronize()
            trials[-1].update(state=event["state"], value=event["value"],
                              launches=launch_counts(),
                              memory_allocated=torch.cuda.memory_allocated(dev))

    events.subscribe(watch)
    vec = ROOT / "output" / "code.vec"
    vec_before = vec.stat().st_mtime if vec.exists() else None
    t0 = time.perf_counter()
    study = find_optimal_hyperparams(
        data, base, n_trials=HPO_TRIALS, seed=0, pruner=MedianPruner(n_startup_trials=1),
        sampler=TPESampler(n_startup_trials=2, seed=0), events=events, device=dev)
    seconds = time.perf_counter() - t0
    if (vec.stat().st_mtime if vec.exists() else None) != vec_before:
        bad.append("a trial wrote output/code.vec")
    for t in trials:
        warm = t["epochs"][1]["epoch_seconds"] if len(t["epochs"]) > 1 else None
        t["warm_epoch_seconds"] = warm
        if t["launches"].get("fused_f32_masked", 0) < 1:
            bad.append(f"trial {t['number']} never launched K3 masked: {t['launches']}")
        if not all(math.isfinite(m["train_loss"]) and math.isfinite(m["test_loss"])
                   for m in t["epochs"]):
            bad.append(f"trial {t['number']}: a non-finite loss in {t['epochs']}")
        print(f"hpo (b) trial {t['number']}: {t['state']} value {t['value']:.6f} params "
              f"{json.dumps(t['params'])}; {len(t['epochs'])} epochs, warm epoch_seconds "
              f"{warm}, train losses {[round(m['train_loss'], 6) for m in t['epochs']]}, "
              f"launches {t['launches']}, memory_allocated {t['memory_allocated']} [{smi}]",
              flush=True)
    growth = trials[-1]["memory_allocated"] - trials[0]["memory_allocated"]
    if len(trials) != HPO_TRIALS or growth > HPO_MEMORY_SLACK:
        bad.append(f"{len(trials)} trials; memory after the last trial {growth} bytes above "
                   "the first's")
    if bad:
        raise AssertionError("hpo (b):\n  " + "\n  ".join(bad))
    print(f"hpo (b): {len(trials)} trials in {seconds:.1f} s, best #{study.best_trial.number} "
          f"value {study.best_value:.6f}; memory after the last trial {growth:+d} bytes from "
          f"the first's [{smi}]", flush=True)
    launches = {}
    for t in trials:
        for key, n in t.pop("launches").items():
            launches[key] = launches.get(key, 0) + n
    # the search space's corners as trials would run them (report_fn set, so
    # nothing saved): the top11 recipe's encode 100 at batch 1024, and the
    # widest encode at the largest batch (4 steps, the last one short)
    corners = {}
    for H, B in ((100, 1024), (300, 2048)):
        epochs = []
        reset_launch_counts()
        result = train(base.with_updates(encode_size=H, batch_size=B), data, device=dev,
                       on_epoch=epochs.append, sinks=(), report_fn=lambda epoch, f1: None)
        counts = launch_counts()
        del result
        release_device_memory()
        if counts.get("fused_f32_masked", 0) < 1 or not all(
                math.isfinite(m["train_loss"]) for m in epochs):
            raise AssertionError(f"hpo (b) corner H={H} B={B}: {epochs}, launches {counts}")
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
        corners[f"H{H}_B{B}"] = {"epoch_seconds": [m["epoch_seconds"] for m in epochs],
                                 "train_steps": epochs[-1]["train_steps"]}
        print(f"hpo (b) corner encode {H} batch {B}: epoch_seconds "
              f"{corners[f'H{H}_B{B}']['epoch_seconds']} (warm: the second), "
              f"{epochs[-1]['train_steps']} train steps, launches {counts} [{smi}]", flush=True)
    return {"trials": trials, "seconds": seconds, "memory_growth": growth,
            "corners": corners, "launches": launches}


def hpo_cli(smi, paths: dict, root: Path) -> dict:
    """(c) the CLI with every telemetry flag (pool_only, 2 epochs,
    prefetched, --profile_steps 4) in a subprocess, and its gates; then
    (d) the projector export of its code.vec; then a two-trial search
    through the CLI with the reference's --gpu and --num_workers."""
    import os

    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors
    from code2vec_tpu_torch.visualize import visualize_code_vectors

    corpus = ["--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
              "--terminal_idx_path", paths["terminal_idx"], "--terminal_embed_size", "100",
              "--path_embed_size", "100", "--encode_size", "100", "--max_path_length",
              str(BAG), "--dropout_prob", "0.25", "--random_seed", "0",
              "--print_sample_cycle", "0"]
    dirs = {k: root / k for k in ("events", "trace", "profile", "model")}
    argv = [sys.executable, "-m", "code2vec_tpu_torch", *corpus, "--batch_size",
            str(TRAIN_BATCH), "--max_epoch", "2", "--use_pallas", "--pallas_impl", "pool_only",
            "--env", "floyd", "--events_dir", str(dirs["events"]), "--trace_dir",
            str(dirs["trace"]), "--profile_dir", str(dirs["profile"]), "--profile_steps", "4",
            "--prefetch_batches", "2", "--model_path", str(dirs["model"]), "--vectors_path",
            str(dirs["model"] / "code.vec")]
    env = {k: v for k, v in os.environ.items() if k != "C2V_FAULT_PLAN"}
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    cli_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"hpo (c): the CLI exited {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    bad = []
    lines = [json.loads(x) for x in open(dirs["events"] / "events-p0.jsonl", encoding="utf-8")]
    manifest = lines[0]
    kind = manifest.get("device_kind", "")
    if manifest["event"] != "manifest" or "H100" not in kind \
            or not manifest.get("costs", {}).get("peak_flops_per_s"):
        bad.append(f"the first line is not a manifest naming the card and its peak: "
                   f"{ {k: manifest.get(k) for k in ('event', 'device_kind', 'costs')} }")
    epochs = [e for e in lines if e["event"] == "epoch"]
    floyd = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith('{"metric"')]
    want = [{"metric": k, "value": v} for e in epochs for k, v in e["metrics"].items()]
    want += [{"metric": "best_f1", "value": e["metrics"]["best_f1"]}
             for e in lines if e["event"] == "best_f1"]
    if sorted(map(json.dumps, floyd)) != sorted(map(json.dumps, want)):
        bad.append(f"{len(floyd)} floyd lines differ from the {len(want)} event metrics")
    for e in epochs:
        device_bytes = e["memory"].get("device", {}).get("bytes_in_use", 0)
        if device_bytes <= 0 or e["health"]["counters"].get("recompiles", 0) != 0:
            bad.append(f"epoch {e['epoch']}: memory.device {e['memory'].get('device')}, "
                       f"counters {e['health']['counters']}")
    mfu = [e["mfu"] for e in lines if e["event"] == "step_sample" and "mfu" in e]
    if not mfu or not all(0 < m <= 1 for m in mfu):
        bad.append(f"step_sample mfu {mfu}")
    trace = json.load(open(dirs["trace"] / "trace-p0.json", encoding="utf-8"))["traceEvents"]
    spans = [e for e in trace if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    need = {"host_build", "h2d", "train_step", "train_pass", "eval_pass"}
    producer = {e["tid"] for e in spans if e["name"] == "host_build"}
    step = {e["tid"] for e in spans if e["name"] == "train_step"}
    if not need <= names or not producer or producer & step:
        bad.append(f"trace spans {sorted(names)}, producer tids {producer}, step tids {step}")
    (profile_file,) = list(dirs["profile"].iterdir())
    profiled = json.load(open(profile_file, encoding="utf-8"))["traceEvents"]
    kernels = {}
    for e in profiled:
        name = e.get("name", "") if e.get("cat") == "kernel" else ""
        k = ("pool_bwd_kernel" if "pool_bwd_kernel" in name
             else "pool_kernel" if "pool_kernel" in name else None)
        if k is not None:
            kernels[k] = kernels.get(k, 0) + 1
    if set(kernels) != {"pool_kernel", "pool_bwd_kernel"}:
        bad.append(f"the profiler trace names {kernels} of K1 / K1b")
    if bad:
        raise AssertionError("hpo (c):\n  " + "\n  ".join(bad))
    print(f"hpo (c): the CLI in {cli_seconds:.1f} s; manifest names {kind!r} at peak "
          f"{manifest['costs']['peak_flops_per_s']:.4g} FLOP/s; {len(floyd)} floyd lines equal "
          f"the epoch events; device bytes in use {[e['memory']['device']['bytes_in_use'] for e in epochs]}; "
          f"recompiles 0; step_sample mfu {mfu}; spans {sorted(need)} with the producer's "
          f"thread apart; the profiled epoch launched {kernels} [{smi}]", flush=True)

    # (d) the projector export of the run's code.vec
    labels, vectors = read_code_vectors(dirs["model"] / "code.vec")
    t0 = time.perf_counter()
    tsv = visualize_code_vectors(dirs["model"] / "code.vec", root / "projector")
    projector_seconds = time.perf_counter() - t0
    with open(tsv["vectors"], encoding="utf-8") as f:
        n_rows = sum(1 for _ in f)
    if n_rows != len(vectors) or not len(vectors):
        raise AssertionError(f"hpo (d): {n_rows} TSV rows for {len(vectors)} vectors")
    print(f"hpo (d): {n_rows} projector rows for {len(labels)} vectors of dim "
          f"{vectors.shape[1]} in {projector_seconds:.2f} s", flush=True)

    # the search through the CLI, with the reference's no-op flags
    t0 = time.perf_counter()
    search = subprocess.run([sys.executable, "-m", "code2vec_tpu_torch", *corpus,
                             "--max_epoch", "1", "--use_pallas", "--pallas_impl", "fused",
                             "--find_hyperparams", "--num_trials", "2", "--gpu", "0",
                             "--num_workers", "4"], cwd=ROOT, env=env, capture_output=True,
                            text=True, timeout=400)
    search_seconds = time.perf_counter() - t0
    if search.returncode != 0 or "Number of finished trials: 2" not in search.stderr:
        raise AssertionError(f"hpo: the CLI search exited {search.returncode}\n"
                             f"{search.stderr[-3000:]}")
    print(f"hpo: the CLI search (--gpu 0 --num_workers 4) ran 2 trials in "
          f"{search_seconds:.1f} s [{smi}]", flush=True)
    return {"cli_seconds": cli_seconds, "mfu": mfu, "profiled_launches": kernels,
            "projector_rows": n_rows, "projector_seconds": projector_seconds,
            "search_cli_seconds": search_seconds}


def phase_train_hpo(torch, smi, dev, tmp: Path, elastic) -> dict:
    """The search's paths on the card: (a) the kernels at its widths, (b)
    a seeded search through the API, (c) the CLI with every telemetry flag
    and (d) the projector export; each part's seconds printed."""
    import shutil

    from code2vec_tpu_torch.data.reader import load_corpus

    root = tmp / "hpo"
    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["a"] = hpo_kernels(torch, dev, smi)
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = (elastic or {}).get("corpus_paths")
    if paths is None:
        paths = write_raw_corpus(train_corpus()[0], root / "corpus")
    data = load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"], cache=False)
    seconds["load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = hpo_search(torch, smi, dev, data)
    seconds["b"] = time.perf_counter() - t0
    del data
    t0 = time.perf_counter()
    out["c"] = hpo_cli(smi, paths, root)
    seconds["c_d"] = time.perf_counter() - t0
    out["seconds"] = seconds
    out["launches"] = dict(out["b"]["launches"])
    # K1/K1b of the pool_only CLI run: its profiled epoch's kernel events
    for key, name in (("pool", "pool_kernel"), ("pool_bwd", "pool_bwd_kernel")):
        out["launches"][key] = out["launches"].get(key, 0) + out["c"]["profiled_launches"][name]
    print(f"train_hpo: seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
          f"launches {json.dumps(out['launches'])} [{smi}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 7d: train_mesh — the (data, model, ctx) mesh: NCCL at world 1, then
# two gloo ranks time-sliced on the one card
# ---------------------------------------------------------------------------

# the train phase's recipe, one epoch, the tables padded to 2 so one world-1
# run is the reference of every mesh shape (vocab_pad_multiple auto follows
# model_axis)
MESH_RECIPE = dict(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                   max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25, max_epoch=1,
                   random_seed=0, print_sample_cycle=0, vocab_pad_multiple=2)
MESH_SIGTERM_STEP = 4
# run -> (config updates, the kernels it must launch, world-1 reference route or None)
MESH_RUNS = {
    "data2_fused": (dict(data_axis=2, profile_steps=3, **kernel_route("fused")),
                    ("fused_f32_masked", "fused_f32"), "fused"),
    "data2_pool_only": (dict(data_axis=2, **kernel_route("pool_only")), ("pool", "pool_bwd"),
                        "pool_only"),
    "model2_fused": (dict(model_axis=2, **kernel_route("fused")),
                     ("fused_f32_masked", "fused_f32"), "fused"),
    "model2_gather_split": (dict(model_axis=2, **kernel_route("gather_split")),
                            ("gather_split_masked", "gather_split"), "gather_split"),
    "host_shard": (dict(data_axis=2, **kernel_route("fused")), ("fused_f32_masked",), None),
    "device_shard": (dict(data_axis=2, device_epoch=True, shard_staged_corpus=True,
                          **kernel_route("fused")), ("fused_f32_masked", "fused_f32"), None),
    # a mid-epoch save at data=2 (SIGTERM to rank 0 after step 4, the ranks'
    # common stop at the periodic save there), resumed at model=2
    "reshape_save": (dict(data_axis=2, checkpoint_every_steps=MESH_SIGTERM_STEP,
                          **kernel_route("fused")),
                     ("fused_f32_masked",), None),
    "reshape_resume": (dict(model_axis=2, resume=True, **kernel_route("fused")),
                       ("fused_f32_masked", "fused_f32"), None),
    # lazy tables over the model axis: each rank steps its row shard's rows
    "model2_lazy_fused": (dict(model_axis=2, table_update="lazy", **kernel_route("fused")),
                          ("fused_f32_masked", "fused_f32"), "lazy_fused"),
    "model2_lazy_gather_split": (dict(model_axis=2, table_update="lazy",
                                      **kernel_route("gather_split")),
                                 ("gather_split_masked", "gather_split"), "lazy_gather_split"),
}
# world-1 reference runs: name -> config updates
MESH_REFS = {route: kernel_route(route) for route in ("fused", "pool_only", "gather_split")}
MESH_REFS.update({f"lazy_{route}": dict(kernel_route(route), table_update="lazy")
                  for route in ("fused", "gather_split")})
MESH_WORKER_TIMEOUT_S = 420
# the serving pair: the retrieval phase's index at model=2, these queries
# one at a time and batched, and a data=2 build of a slice of its rows
MESH_SERVE_QUERIES = 64
MESH_BUILD = dict(n=100_000, n_list=100, m=ANN_M, kmeans_iters=10, pq_iters=8)


def record_steps(torch, step_ms: list | None = None):
    """Patch the loop's and the device runner's step to record each step's
    loss (read back at once), and into ``step_ms`` its wall ms up to that
    read: ``(losses list, undo)``."""
    from code2vec_tpu_torch.train import device_epoch, loop

    losses, real = [], loop.train_step

    def recording(model, optimizer, batch, class_weights):
        t0 = time.perf_counter()
        loss = real(model, optimizer, batch, class_weights)
        losses.append(float(loss))
        if step_ms is not None:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return loss

    loop.train_step = device_epoch.train_step = recording

    def undo():
        loop.train_step = device_epoch.train_step = real

    return losses, undo


def mesh_worker(spec_path: str, rank: int) -> int:
    """One rank of the train_mesh phase's pair: a gloo group over the one
    card (``LOCAL_RANK`` 0 on both), formed before ``train()``, then every
    run of the spec; each run's epochs, per-step losses, launches and the
    data axis's gradient all-reduces (ms and bytes) saved for the parent."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    spec = json.loads(Path(spec_path).read_text())
    os.environ["LOCAL_RANK"] = "0"
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("gloo", init_method="file://" + spec["init"], rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    from code2vec_tpu_torch.checkpoint import restore_checkpoint, slot_path
    from code2vec_tpu_torch.data.reader import load_corpus
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.parallel import step as pstep
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    from code2vec_tpu_torch.parallel.shardings import shard_model, unshard_state
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import model_config_from, train
    from code2vec_tpu_torch.train.step import make_optimizer

    paths = spec["corpus"]
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    data = load_corpus(*args, cache=False)
    losses, _ = record_steps(torch)
    syncs, real_sync = [], pstep.sync_gradients

    def timed_sync(model, mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = real_sync(model, mesh)
        torch.cuda.synchronize()
        syncs.append(((time.perf_counter() - t0) * 1e3, moved))
        return moved

    pstep.sync_gradients = timed_sync
    out = {}
    try:
        if spec.get("serve"):
            out["serve"] = mesh_serve_worker(torch, spec["serve"], rank)
        for name in spec["runs"]:
            updates = dict(MESH_RUNS[name][0])
            out_dir = spec["ckpt"] if name.startswith("reshape") else None
            if name == "reshape_save" and rank == 0:
                updates["fault_plan"] = f"train_step@{MESH_SIGTERM_STEP}:sigterm"
            config = TrainConfig(**MESH_RECIPE, **updates)
            run_data = (load_corpus(*args, cache=False, shard=(rank, 2)) if name == "host_shard"
                        else data)
            rec = {}
            if name == "reshape_resume":
                # every tensor restored onto model=2 equals the data=2 save's bitwise
                mesh = make_mesh(1, 2, 1)
                model = Code2Vec(model_config_from(config, data)).to("cuda")
                shard_model(model, mesh)
                opt = make_optimizer(model, config)
                info = {}
                restore_checkpoint(out_dir, model, opt, np.random.default_rng(0), 2, mesh=mesh,
                                   info=info)
                msd, osd = unshard_state(mesh, model, opt)
                saved = torch.load(slot_path(out_dir, info["slot"]), map_location="cpu",
                                   weights_only=False)
                same = all(torch.equal(msd[k].cpu(), v) for k, v in saved["model"].items())
                for i, st in saved["optimizer"]["state"].items():
                    for k, v in st.items():
                        got = osd["state"][i][k]
                        same &= (torch.equal(got.cpu(), v) if isinstance(v, torch.Tensor)
                                 else got == v)
                rec["restore"] = {"bitwise": bool(same), "slot": info["slot"],
                                  "saved_mesh_shape": info["saved_mesh_shape"],
                                  "resharded": info["resharded"],
                                  "cursor_step": saved["meta"]["cursor"]["step"]}
                del model, opt, msd, osd, saved
                torch.cuda.empty_cache()
            epochs = []
            losses.clear()
            syncs.clear()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            result = train(config, run_data, out_dir, device="cuda", on_epoch=epochs.append,
                           sinks=())
            torch.cuda.synchronize()
            rec.update(epochs=epochs, losses=list(losses), launches=launch_counts(),
                       seconds=time.perf_counter() - t0, syncs=list(syncs),
                       history=result.history)
            out[name] = rec
            print(f"mesh rank {rank} {name}: {len(losses)} steps in {rec['seconds']:.1f} s, "
                  f"launches {rec['launches']}", flush=True)
            del result
            torch.cuda.empty_cache()
    finally:
        pstep.sync_gradients = real_sync
        Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()
    return 0


def array_digests(index) -> dict:
    """sha256 of each array of an ``IvfPqIndex`` (a bitwise comparison
    across processes)."""
    import hashlib

    return {f: hashlib.sha256(np.ascontiguousarray(getattr(index, f)).tobytes()).hexdigest()
            for f in ("centroids", "codebooks", "codes", "scales", "ids", "cell_counts")}


def serve_queries(unit: np.ndarray) -> np.ndarray:
    """The serving pair's queries: perturbed rows of the index's corpus."""
    g = np.random.default_rng(23)
    picks = unit[g.integers(0, len(unit), MESH_SERVE_QUERIES)]
    return (picks + 0.05 * g.normal(size=picks.shape)).astype(np.float32)


def mesh_serve_worker(torch, spec: dict, rank: int) -> dict:
    """(c) One rank of the serving pair: the exact index and the ann
    index of the retrieval phase's container at model=2 (every rank the
    same queries, one at a time, then all 64), the K5 launches of the
    ann queries, and a data=2 build of the first ``MESH_BUILD["n"]`` rows."""
    from code2vec_tpu_torch.ann.index import build_index, load_index
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    from code2vec_tpu_torch.serve.retrieval import AnnRetrievalIndex, RetrievalIndex

    mesh = make_mesh(1, 2, 1)
    index, unit, labels = load_index(spec["index"])
    queries = serve_queries(np.asarray(unit))
    out = {}
    for backend in ("exact", "ann"):
        t0 = time.perf_counter()
        if backend == "exact":
            served = RetrievalIndex(labels, np.asarray(unit), mesh=mesh, device="cuda")
        else:
            served = AnnRetrievalIndex(labels, unit, index, n_probe=ANN_PROBE,
                                       shortlist=ANN_SHORTLIST, mesh=mesh, device="cuda")
        load_s = time.perf_counter() - t0
        served.top_k(queries[0], 10)  # warm (the answers come back to the host)
        reset_launch_counts()
        lat = []
        for q in queries:
            t0 = time.perf_counter()
            served.top_k(q, 10)
            lat.append((time.perf_counter() - t0) * 1e3)
        rec = {"load_s": load_s, "p50_ms": float(np.percentile(lat, 50)),
               "p99_ms": float(np.percentile(lat, 99)), "launches": launch_counts(),
               "describe": {k: v for k, v in served.describe().items() if k != "schedule"}}
        if backend == "exact":
            top = served.top_k_batch(queries, 10)
            rec["ids"] = [[int(n[1:]) for n, _ in row] for row in top]
            rec["scores"] = [[s for _, s in row] for row in top]
        else:
            s_, i_ = served.searcher.search(queries)
            rec["ids"], rec["scores"] = i_.tolist(), s_.tolist()
        out[backend] = rec
        served.close()
        del served
        print(f"mesh rank {rank} serve {backend}: p50 {rec['p50_ms']:.3f} ms, launches "
              f"{rec['launches']}", flush=True)
    build = MESH_BUILD
    t0 = time.perf_counter()
    built, _ = build_index(np.asarray(unit[:build["n"]]), n_list=build["n_list"], m=build["m"],
                           seed=0, kmeans_iters=build["kmeans_iters"],
                           pq_iters=build["pq_iters"], mesh=make_mesh(2, 1, 1), device="cuda")
    out["build"] = {"seconds": time.perf_counter() - t0, "digests": array_digests(built)}
    print(f"mesh rank {rank} build data=2: {out['build']['seconds']:.1f} s", flush=True)
    return out


def same_top(ids_a, scores_a, ids_b, scores_b, tol=1e-5) -> bool:
    """Scores within ``tol`` and ids equal, save the order inside a run of
    scores within ``tol`` of their neighbour."""
    for ia, sa, ib, sb in zip(ids_a, scores_a, ids_b, scores_b):
        sa, sb = np.asarray(sa, np.float64), np.asarray(sb, np.float64)
        if len(ia) != len(ib) or np.max(np.abs(sa - sb)) > tol:
            return False
        cut = np.flatnonzero(np.abs(np.diff(sa)) > tol) + 1
        if any(sorted(a.tolist()) != sorted(b.tolist())
               for a, b in zip(np.split(np.asarray(ia), cut), np.split(np.asarray(ib), cut))):
            return False
    return True


def mesh_serve_check(smi, ann_path: Path, ranks: list, bad: list) -> dict:
    """(c) The serving pair against one device on the same container: the
    exact top-10, the ann shortlists, K5 on each rank, the data=2 build."""
    from code2vec_tpu_torch.ann.index import build_index, load_index
    from code2vec_tpu_torch.serve.retrieval import AnnRetrievalIndex, RetrievalIndex

    index, unit, labels = load_index(str(ann_path))
    queries = serve_queries(np.asarray(unit))
    r0, r1 = (r["serve"] for r in ranks)
    exact = RetrievalIndex(labels, np.asarray(unit), device="cuda")
    top = exact.top_k_batch(queries, 10)
    want = ([[int(n[1:]) for n, _ in row] for row in top], [[s for _, s in row] for row in top])
    del exact
    ann = AnnRetrievalIndex(labels, unit, index, n_probe=ANN_PROBE, shortlist=ANN_SHORTLIST,
                            device="cuda")
    s_one, i_one = ann.searcher.search(queries)
    del ann
    build = MESH_BUILD
    t0 = time.perf_counter()
    one_build, _ = build_index(np.asarray(unit[:build["n"]]), n_list=build["n_list"],
                               m=build["m"], seed=0, kmeans_iters=build["kmeans_iters"],
                               pq_iters=build["pq_iters"], device="cuda")
    one_build_s = time.perf_counter() - t0
    for backend in ("exact", "ann"):
        if (r0[backend]["ids"], r0[backend]["scores"]) != (r1[backend]["ids"],
                                                           r1[backend]["scores"]):
            bad.append(f"serve {backend}: the ranks' answers differ")
    if not same_top(*want, r0["exact"]["ids"], r0["exact"]["scores"]):
        bad.append("serve exact: the model=2 top-10 is not one device's")
    if not same_shortlist(np.asarray(r0["ann"]["scores"], np.float32), np.asarray(r0["ann"]["ids"]),
                          s_one, i_one):
        bad.append("serve ann: the model=2 shortlists are not one device's")
    k5 = [r["ann"]["launches"].get("lut_score", 0) for r in (r0, r1)]
    if min(k5) < MESH_SERVE_QUERIES:
        bad.append(f"serve ann: K5 launches a rank {k5}, want >= {MESH_SERVE_QUERIES}")
    want_digests = array_digests(one_build)
    same_build = [r["build"]["digests"] == want_digests for r in (r0, r1)]
    if not all(same_build):
        bad.append(f"build data=2: not bitwise world 1's ({r0['build']['digests']} vs "
                   f"{want_digests})")
    out = {b: {k: r0[b][k] for k in ("p50_ms", "p99_ms", "load_s", "describe")}
           | {"launches": [r0[b]["launches"], r1[b]["launches"]]} for b in ("exact", "ann")}
    out["build"] = {"seconds": [r0["build"]["seconds"], r1["build"]["seconds"]],
                    "world1_seconds": one_build_s, "bitwise": same_build}
    print(f"mesh (c) serving at model=2, gloo on one time-sliced card (not NCCL across cards), "
          f"{MESH_SERVE_QUERIES} queries one at a time over {len(labels)} rows: exact p50 "
          f"{out['exact']['p50_ms']:.3f} ms p99 {out['exact']['p99_ms']:.3f} ms, ann (n_probe "
          f"{ANN_PROBE}, shortlist {ANN_SHORTLIST}) p50 {out['ann']['p50_ms']:.3f} ms p99 "
          f"{out['ann']['p99_ms']:.3f} ms, K5 launches a rank {k5}; data=2 build of "
          f"{build['n']} rows bitwise world 1's {same_build} in {r0['build']['seconds']:.1f} s "
          f"(world 1 {one_build_s:.1f} s) [{smi}]", flush=True)
    return out


def mesh_nccl_world1(torch, tmp: Path) -> dict:
    """(a) The port's collective Functions over an NCCL group of one rank on
    ``cuda:0``: each equals its expected value (the identity at world 1,
    forward and backward)."""
    import torch.distributed as dist

    from code2vec_tpu_torch.parallel import distributed as pd

    dist.init_process_group("nccl", init_method=f"file://{tmp / 'nccl-rendezvous'}", rank=0,
                            world_size=1)
    try:
        g = dist.group.WORLD
        dev = torch.device("cuda", 0)
        x = torch.randn(4, 6, device=dev, requires_grad=True)
        checks = {}
        y = pd.reduce_from_group(x, g)
        (gy,) = torch.autograd.grad(y, x, torch.ones_like(y))
        checks["reduce_from_group"] = bool(torch.equal(y, x) and torch.equal(gy, torch.ones_like(x)))
        y = pd.copy_to_group(x, g)
        (gy,) = torch.autograd.grad(y, x, 2 * torch.ones_like(y))
        checks["copy_to_group"] = bool(torch.equal(y, x) and torch.equal(gy, 2 * torch.ones_like(x)))
        for dim in (0, 1):
            y = pd.gather_from_group(x, g, dim)
            cot = torch.randn_like(y)
            (gy,) = torch.autograd.grad(y, x, cot)
            checks[f"gather_from_group dim {dim}"] = bool(torch.equal(y, x)
                                                          and torch.equal(gy, cot))
        checks["all_reduce_max"] = bool(torch.equal(pd.all_reduce_max(x, g), x.detach()))
        checks["all_reduce_sum"] = bool(torch.equal(pd.all_reduce_sum(x, g), x.detach()))
        checks["broadcast_flag"] = pd.broadcast_flag(True) and not pd.broadcast_flag(False)
        checks["allgather_to_host"] = bool(np.array_equal(
            pd.allgather_to_host(np.arange(5), pd_mesh_world1()), np.arange(5)))
        pd.barrier()
    finally:
        dist.destroy_process_group()
    version = ".".join(map(str, torch.cuda.nccl.version()))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"mesh (a): the collectives over NCCL at world 1 failed {bad}")
    print(f"mesh (a): NCCL {version} at world 1 on cuda:0: {len(checks)} collective checks "
          f"pass ({', '.join(checks)})", flush=True)
    return {"nccl_version": version, "checks": checks}


def pd_mesh_world1():
    """A one-rank mesh whose data line is the world group (NCCL at world 1)."""
    import torch.distributed as dist

    from code2vec_tpu_torch.parallel.mesh import Mesh

    return Mesh(grid=np.zeros((1, 1, 1), np.int64), rank=0, groups={"data": dist.group.WORLD})


def mesh_rows_check(torch, dev, smi) -> dict:
    """K2 through ``encode_attend_pool_rows``, the wrapper ``gather_split``
    launches on a row-sharded mesh (its rows from the model line's
    all-reduce), at the main path's shape and the recipe's widths: f32 and
    bf16 rows, with and without the keep mask, each held against
    ``encode_pool_reference`` on the same rows at the K2 tolerance."""
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        encode_attend_pool_rows,
        encode_pool_reference,
    )

    B, L = TRAIN_SHAPE
    et, ep, H = (MESH_RECIPE[k] for k in ("terminal_embed_size", "path_embed_size",
                                           "encode_size"))
    D = 2 * et + ep
    g = torch.Generator(device=dev).manual_seed(1717)
    rows = [torch.randn(B, L, w, generator=g, device=dev) for w in (et, ep, et)]
    mask = bag_keep(torch, dev, g, B, L).float()
    params = (torch.randn(D, H, generator=g, device=dev) / math.sqrt(D),
              1.0 + 0.1 * torch.randn(H, generator=g, device=dev),
              0.1 * torch.randn(H, generator=g, device=dev),
              0.08 * torch.randn(H, generator=g, device=dev))
    drop = torch.empty(B, L, H, device=dev).bernoulli_(KEEP, generator=g) / KEEP
    out = {}
    for cd, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cast = [r.to(cd) for r in rows]
        for keep in (None, drop):
            name = f"{label}{'' if keep is None else ' masked'}"
            cv, w = encode_attend_pool_rows(*cast, mask, *params, keep, compute_dtype=cd)
            cv_ref, w_ref = encode_pool_reference(*cast, mask, *params, keep)
            torch.cuda.synchronize()
            if not (torch.isfinite(cv).all() and torch.isfinite(w).all()):
                raise AssertionError(f"mesh K2 over rows {name}: non-finite output")
            torch.testing.assert_close(cv, cv_ref, rtol=TOL, atol=TOL)
            torch.testing.assert_close(w, w_ref, rtol=TOL, atol=TOL)
            out[name] = max((cv - cv_ref).abs().max().item(), (w - w_ref).abs().max().item())
    print(f"mesh K2 over gathered rows (encode_attend_pool_rows) at {(B, L)}, widths "
          f"{(et, ep, et)} -> {H}, against encode_pool_reference within rtol=atol={TOL}: "
          + ", ".join(f"{k} max_abs_err={v:.3e}" for k, v in out.items()) + f" [{smi}]",
          flush=True)
    return out


def mesh_references(torch, dev, data) -> dict:
    """The world-1 runs the mesh runs are held against (``MESH_REFS``):
    fused, pool_only and gather_split at the recipe, and lazy tables on
    fused and gather_split, each step's loss recorded."""
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import train

    refs = {}
    for route, updates in MESH_REFS.items():
        losses, undo = record_steps(torch)
        try:
            epochs = []
            train(TrainConfig(**MESH_RECIPE, **updates), data, device=dev,
                  on_epoch=epochs.append, sinks=())
        finally:
            undo()
        refs[route] = {"losses": list(losses), "epochs": epochs}
        print(f"mesh reference world 1 {route}: step losses "
              f"{[round(x, 6) for x in losses]}", flush=True)
    return refs


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want))) if len(want) else 0.0


def phase_train_mesh(torch, smi, dev, tmp: Path, elastic) -> dict:
    """(a) NCCL at world 1, and K2 over gathered rows against its plain
    version; (b) two gloo ranks on the one card, each a
    process this script starts (``LOCAL_RANK`` 0), through every run of
    ``MESH_RUNS``: the ranks' per-step losses bitwise equal, data=2 and
    model=2 (lazy tables too) within rtol 2e-5 of the world-1 run of their
    route, the host-sharded and the
    sharded device-epoch runs, the reshape restore bitwise; a data=2 step's
    device and collective ms and the bytes it all-reduces (gloo on one
    time-sliced card, not NCCL across cards); (c) the pair serving at
    model=2 over the retrieval phase's container (``tmp / "ann.index"``)
    and building at data=2 (:func:`mesh_serve_check`)."""
    import shutil

    from code2vec_tpu_torch.data.reader import load_corpus

    root = tmp / "mesh"
    root.mkdir(parents=True, exist_ok=True)
    out = {"a": mesh_nccl_world1(torch, root), "rows_kernel": mesh_rows_check(torch, dev, smi)}
    paths = (elastic or {}).get("corpus_paths")
    if paths is None:
        paths = write_raw_corpus(train_corpus()[0], root / "corpus")
    data = load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"], cache=False)
    refs = mesh_references(torch, dev, data)
    del data
    torch.cuda.empty_cache()
    ann_path = tmp / "ann.index"
    if not ann_path.exists():
        raise AssertionError(f"mesh (c) serves the retrieval phase's index: {ann_path} is missing")
    spec = {"init": str(root / "gloo-rendezvous"), "out": str(root), "corpus": paths,
            "ckpt": str(root / "ckpt"), "runs": list(MESH_RUNS),
            "serve": {"index": str(ann_path)}}
    (root / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh_worker",
                               str(root / "spec.json"), str(r)],
                              stdout=open(root / f"rank{r}.log", "w"), stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        for proc in procs:
            proc.wait(timeout=MESH_WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    for r, proc in enumerate(procs):
        log = (root / f"rank{r}.log").read_text()
        print("\n".join(f"  [rank {r}] {line}" for line in log.splitlines()
                        if line.startswith("mesh rank") or "Error" in line
                        or "Traceback" in line)[-4000:], flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"mesh (b): rank {r} exited {proc.returncode}:\n{log[-6000:]}")
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(2)]
    bad, runs = [], {}
    out["c"] = mesh_serve_check(smi, ann_path, ranks, bad)
    for name, (_, keys, ref) in MESH_RUNS.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        metrics = ("train_loss", "test_loss", "accuracy", "f1")
        if r0["losses"] != r1["losses"] or [[e[k] for k in metrics] for e in r0["epochs"]] != \
                [[e[k] for k in metrics] for e in r1["epochs"]]:
            bad.append(f"{name}: the ranks' losses differ")
        if not all(math.isfinite(x) for x in r0["losses"]) or not r0["losses"]:
            bad.append(f"{name}: losses {r0['losses']}")
        missing = [k for k in keys if r0["launches"].get(k, 0) < 1 or r1["launches"].get(k, 0) < 1]
        if missing:
            bad.append(f"{name}: never launched {missing} ({r0['launches']})")
        gap = None
        if ref is not None:
            gap = rel_gap(r0["losses"], refs[ref]["losses"])
            if gap > 2e-5:
                bad.append(f"{name}: step losses {gap:.3e} from world 1 ({ref}), bar 2e-5")
        runs[name] = {"losses": r0["losses"], "launches": [r0["launches"], r1["launches"]],
                      "seconds": [r0["seconds"], r1["seconds"]], "gap_to_world1": gap,
                      "epochs": [r0["epochs"], r1["epochs"]]}
        print(f"mesh (b) {name}: {len(r0['losses'])} steps, ranks bitwise "
              f"{r0['losses'] == r1['losses']}, gap to world 1 "
              f"{'-' if gap is None else f'{gap:.3e}'}, seconds {r0['seconds']:.1f}, "
              f"rank 0 launches {r0['launches']} [{smi}]", flush=True)
    # the host-sharded feed and the sharded staging: each rank its share
    shard = ranks[0]["host_shard"]["epochs"][0], ranks[1]["host_shard"]["epochs"][0]
    if shard[0]["train_loss"] != shard[1]["train_loss"] or shard[0]["f1"] != shard[1]["f1"]:
        bad.append("host_shard: the ranks' epoch metrics differ")
    staged = [ranks[r]["device_shard"]["epochs"][0]["staged_bytes"] for r in range(2)]
    share = staged[0] / sum(staged)
    if not 0.4 <= share <= 0.6:
        bad.append(f"device_shard: staged bytes {staged} (rank 0's share {share:.3f})")
    # the reshape: restored bitwise onto model=2, the resumed tail within rtol
    # 2e-5 of the world-1 run's steps and epoch loss
    restore = ranks[0]["reshape_resume"]["restore"]
    tail = ranks[0]["reshape_resume"]["losses"]
    want_tail = refs["fused"]["losses"][MESH_SIGTERM_STEP:]
    tail_gap = rel_gap(tail, want_tail)
    epoch_gap = rel_gap([ranks[0]["reshape_resume"]["epochs"][0]["train_loss"]],
                        [refs["fused"]["epochs"][0]["train_loss"]])
    saved_steps = len(ranks[0]["reshape_save"]["losses"])
    if not (restore["bitwise"] and restore["cursor_step"] == MESH_SIGTERM_STEP
            and saved_steps == MESH_SIGTERM_STEP and restore["resharded"]
            and len(tail) == len(want_tail)):
        bad.append(f"reshape: restore {restore}, {saved_steps} steps saved, tail {len(tail)}")
    if max(tail_gap, epoch_gap) > 2e-5:
        bad.append(f"reshape: resumed losses {tail_gap:.3e} / epoch {epoch_gap:.3e} from "
                   "world 1, bar 2e-5")
    # a data=2 step: the device ms (the profiled steps' compute less the
    # all-reduce) and the collective ms, gloo on one time-sliced card
    d2 = ranks[0]["data2_fused"]
    sync_ms = [ms for ms, _ in d2["syncs"]]
    grad_bytes = d2["syncs"][0][1] if d2["syncs"] else 0
    compute_ms = d2["epochs"][0].get("compute_ms")
    collective_ms = float(np.median(sync_ms)) if sync_ms else None
    out["b"] = {"runs": runs, "seconds": seconds, "staged_bytes": staged,
                "restore": restore, "reshape_tail_gap": tail_gap, "reshape_epoch_gap": epoch_gap,
                "data2_step": {"compute_ms": compute_ms, "collective_ms": collective_ms,
                               "device_ms": (None if compute_ms is None or collective_ms is None
                                             else compute_ms - collective_ms),
                               "all_reduce_bytes": grad_bytes, "sync_ms": sync_ms}}
    print(f"mesh (b): the pair ran {len(MESH_RUNS)} runs in {seconds:.1f} s; host-sharded "
          f"epoch loss {shard[0]['train_loss']:.6f} on both ranks; sharded staging "
          f"{staged} bytes (rank 0 {share:.3f} of the sum); reshape: restore {restore}, the "
          f"resumed steps {tail_gap:.3e} and the epoch loss {epoch_gap:.3e} from world 1 "
          f"[{smi}]", flush=True)
    print(f"mesh (b) data=2 step, gloo on one time-sliced card (not NCCL across cards): "
          f"profiled step {compute_ms} ms of which the gradient all-reduce "
          f"{collective_ms} ms (median of {len(sync_ms)}), so device+host {out['b']['data2_step']['device_ms']} ms; "
          f"{grad_bytes} bytes all-reduced a step [{smi}]", flush=True)
    if bad:
        raise AssertionError("train_mesh:\n  " + "\n  ".join(bad))
    out["launches"] = {}
    for r in range(2):
        for name, rec in ranks[r].items():
            for counts in ([rec["exact"]["launches"], rec["ann"]["launches"]] if name == "serve"
                           else [rec["launches"]]):
                for key, n in counts.items():
                    out["launches"][key] = out["launches"].get(key, 0) + n
    print(f"train_mesh launches (both ranks): {json.dumps(out['launches'])}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 7e: autotune — the kernel-schedule autotuner and pallas_impl="auto"
# ---------------------------------------------------------------------------

# the keys tuned at the top11 widths: (batch, width, table dtype) — training,
# serving at batch 1 and 64 (f32 and int8 tables), a long bag
AT_KEYS = [(TRAIN_BATCH, BAG, "f32"), (1, BAG, "f32"), (1, BAG, "int8"), (64, BAG, "f32"),
           (64, BAG, "int8"), (64, 1024, "f32")]
AT_HOLD_KEY = (64, BAG, "f32")  # each variant's code vectors held to the plain route here
AT_SERVE_BATCHES = (1, 64)
AT_DEVICE = "cuda"  # the --device of the phase's trainer runs
# variant labels PERF.md names beforehand as expected to raise, with the
# reason: none (every route runs at every key on the card)
AT_EXPECTED_SKIPS: dict[str, str] = {}
# (impl, softmax) -> the kernels a training run on that route launches (the
# masked train step's and the eval pass's)
AT_TRAIN_KERNELS = {
    ("xla", "materialize"): (),
    ("pool_only", "materialize"): ("pool", "pool_bwd"),
    ("gather_split", "materialize"): ("gather_split_masked", "gather_split"),
    ("fused", "materialize"): ("fused_f32_masked", "fused_f32"),
    ("fused", "online"): ("online_f32_masked", "online_f32"),
    ("fused", "two_pass"): ("two_pass_f32_masked", "two_pass_f32"),
}


def add_counts(total: dict, counts: dict) -> dict:
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n
    return total


def autotune_search(torch, smi, dev, cache_path: Path, lut_key, launches: dict) -> dict:
    """(a) every variant of the forward keys and the LUT key timed into a
    fresh cache: one line a key, the winner gated to be the fastest finite
    timing, every skip listed (one not in ``AT_EXPECTED_SKIPS`` fails);
    then each variant's code vectors at ``AT_HOLD_KEY`` against the plain
    route's (the serve phase's bar)."""
    import contextlib
    import io

    from code2vec_tpu_torch.ops import autotune as at
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    c = TOP11
    kind = at.device_kind(dev)
    keys = [at.ShapeKey(kind, b, w, c["terminal_embed_size"], c["path_embed_size"],
                        c["encode_size"], dt) for b, w, dt in AT_KEYS]
    memo: dict = {}
    err = io.StringIO()
    reset_launch_counts()
    before = at.counters_snapshot()
    with contextlib.redirect_stderr(err):
        found = at.autotune(keys, cache=at.ScheduleCache(str(cache_path)),
                            vocab=c["terminal_count"], device=dev, inputs_memo=memo)
        found.update(at.autotune_lut([lut_key], cache=at.ScheduleCache(str(cache_path)),
                                     device=dev))
    torch.cuda.synchronize()
    add_counts(launches, launch_counts())
    counters = {k: v - before[k] for k, v in at.counters_snapshot().items()}
    skip_lines = [x for x in err.getvalue().splitlines() if x.startswith("autotune:")]
    entries = json.loads(cache_path.read_text())["entries"]
    out, bad = {}, []
    for key in keys + [lut_key]:
        entry = entries[key.cache_key()]
        timings = entry["timings_ms"]
        sched = found[key.cache_key()]
        if isinstance(key, at.ShapeKey):
            space = [at._variant_label(v) for v in at.enumerate_variants(
                key.batch, key.width, key.table_dtype, dev)]
            winner = at._variant_label(sched)
        else:
            space = [at._lut_variant_label(v) for v in at.enumerate_lut_variants(
                key.capacity, dev)]
            winner = at._lut_variant_label(sched)
        skips = sorted(k for k, t in timings.items() if not math.isfinite(t))
        finite = {k: t for k, t in timings.items() if math.isfinite(t)}
        fastest = min(finite, key=finite.get) if finite else None
        if sorted(timings) != sorted(space):
            bad.append(f"{key.cache_key()}: timed {sorted(timings)}, the space is {space}")
        if winner != fastest:
            bad.append(f"{key.cache_key()}: the winner {winner} is not the fastest {fastest}")
        unexpected = [s for s in skips if s not in AT_EXPECTED_SKIPS]
        if unexpected:
            bad.append(f"{key.cache_key()}: unexpected skips {unexpected}")
        out[key.cache_key()] = {"timings_ms": timings, "winner": winner,
                                "schedule": sched.to_dict(), "skips": skips}
        print(f"autotune {key.cache_key()}: "
              + ", ".join(f"{k} {t}" for k, t in timings.items())
              + f" -> {winner}; skips: {skips or 'none'} [{smi}]", flush=True)
    for line in skip_lines:
        print(f"  {line}", flush=True)
    if counters["autotune_timing_run"] != sum(len(v["timings_ms"]) for v in out.values()):
        bad.append(f"timing runs {counters} vs the timings written")

    # outside the timing: every variant's code vectors at one key, against the plain route
    hold = next(k for k in keys if (k.batch, k.width, k.table_dtype) == AT_HOLD_KEY)
    inputs = at._synth_inputs(hold, c["terminal_count"], device=dev, memo=memo)
    ref = inputs.forward(at.KernelSchedule(impl="xla", backend="gpu"))[1].cpu().numpy()
    held = {}
    for variant in at.enumerate_variants(hold.batch, hold.width, hold.table_dtype, dev):
        cv = inputs.forward(variant)[1].cpu().numpy()
        held[at._variant_label(variant)] = float(np.abs(cv - ref).max())
        if not np.allclose(cv, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL):
            bad.append(f"{at._variant_label(variant)} at {hold.cache_key()}: code vectors "
                       f"{held[at._variant_label(variant)]:.3e} from the plain route's")
    print(f"autotune (a) at {hold.cache_key()}: max |cv - plain| per variant "
          f"{json.dumps(held)} (rtol {SERVE_RTOL}, atol {SERVE_ATOL}) [{smi}]", flush=True)
    del inputs, memo
    if bad:
        raise AssertionError("autotune (a): " + "; ".join(bad))
    return {"keys": out, "counters": counters, "held_max_abs_err": held,
            "skip_lines": skip_lines}


def autotune_expect_cached(cache_path: Path, lut_key) -> dict:
    """(b) the tuner's CLI again over every key with ``--expect-cached``:
    the forward groups in process, the LUT key as ``python -m``; each exit
    0 with no timing run."""
    import contextlib
    import io

    from code2vec_tpu_torch.ops import autotune as at

    c = TOP11
    dims = ["--terminal-embed", str(c["terminal_embed_size"]), "--path-embed",
            str(c["path_embed_size"]), "--encode", str(c["encode_size"]), "--cache",
            str(cache_path), "--expect-cached", "--backend", "gpu"]
    groups = {}
    for b, w, dt in AT_KEYS:
        groups.setdefault((b, w), []).append(dt)
    runs = []
    for (b, w), dts in groups.items():
        argv = ["--batch", str(b), "--widths", str(w), "--table-dtypes", ",".join(dts), *dims]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = at.main(argv)
        runs.append((" ".join(argv[:6]), rc, json.loads(out.getvalue().splitlines()[-1])))
    argv = [sys.executable, "-m", "code2vec_tpu_torch.ops.autotune", "--lut", "--lut-m",
            str(lut_key.m), "--lut-n-list", str(lut_key.n_list), "--lut-capacity",
            str(lut_key.capacity), "--lut-shortlist", str(lut_key.shortlist), "--cache",
            str(cache_path), "--expect-cached", "--backend", "gpu"]
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    runs.append(("--lut (python -m)", proc.returncode, json.loads(lines[-1]) if lines else {}))
    bad = [(name, rc, rec.get("counters")) for name, rc, rec in runs
           if rc != 0 or rec.get("counters", {}).get("autotune_timing_run") != 0
           or rec.get("counters", {}).get("autotune_cache_miss") != 0]
    for name, rc, rec in runs:
        print(f"autotune (b) {name} --expect-cached: exit {rc}, counters "
              f"{json.dumps(rec.get('counters'))}", flush=True)
    if bad:
        raise AssertionError(f"autotune (b): {bad}\n{proc.stderr[-2000:]}")
    return {"runs": [{"args": name, "rc": rc, "counters": rec.get("counters")}
                     for name, rc, rec in runs]}


def autotune_train(torch, smi, corpus: dict, root: Path, cache_path: Path, schedule: dict,
                   launches: dict) -> dict:
    """(c) one epoch of the train phase's corpus and recipe through the CLI
    with ``--pallas_impl auto --autotune_cache``, then on the fixed route
    the 1024x200 schedule names: every step's loss bitwise equal, and the
    auto run's launches exactly that route's kernels. The tuner ranks
    routes by their forward alone, so an epoch on ``pool_only`` and one on
    the plain route follow (where the schedule names neither), each warm
    step's ms beside the picked route's: reported, not gated."""
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    route = (schedule["impl"], schedule["softmax"])
    common = ["--corpus_path", corpus["corpus"], "--path_idx_path", corpus["path_idx"],
              "--terminal_idx_path", corpus["terminal_idx"], "--terminal_embed_size", "100",
              "--path_embed_size", "100", "--encode_size", "100", "--max_path_length",
              str(BAG), "--batch_size", str(TRAIN_BATCH), "--dropout_prob", "0.25",
              "--random_seed", "0", "--print_sample_cycle", "0", "--max_epoch", "1",
              "--device", AT_DEVICE]
    fixed_flags = ([] if route[0] == "xla" else
                   ["--use_pallas", "--pallas_impl", route[0], "--pallas_softmax", route[1]])
    others = [(name, flags) for name, impl, flags in (
        ("pool_only", "pool_only", ["--use_pallas", "--pallas_impl", "pool_only"]),
        ("plain", "xla", [])) if impl != route[0]]
    runs = {}
    for name, flags in (("auto", ["--use_pallas", "--pallas_impl", "auto",
                                  "--autotune_cache", str(cache_path)]),
                        ("fixed", fixed_flags), *others):
        out = root / f"train_{name}"
        step_ms = []
        losses, undo = record_steps(torch, step_ms)
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rc = cli.main(common + flags + ["--model_path", str(out), "--vectors_path",
                                            str(out / "code.vec")])
        finally:
            undo()
        torch.cuda.synchronize()
        warm = float(np.median(step_ms[1:])) if len(step_ms) > 1 else float("nan")
        runs[name] = {"rc": rc, "losses": losses, "launches": launch_counts(),
                      "seconds": time.perf_counter() - t0, "warm_step_ms": warm,
                      "step_ms": step_ms}
        print(f"autotune (c) {name} ({' '.join(flags[:5])}): exit {rc}, {len(losses)} steps, "
              f"losses {losses}, launches {runs[name]['launches']}, warm step "
              f"{warm:.3f} ms (median of steps 2-{len(step_ms)}; each "
              f"{[round(x, 3) for x in step_ms]}), {runs[name]['seconds']:.1f}s [{smi}]",
              flush=True)
    add_counts(launches, runs["auto"]["launches"])
    want = set(AT_TRAIN_KERNELS[route])
    bad = []
    if any(r["rc"] for r in runs.values()):
        bad.append(f"exit codes {({k: r['rc'] for k, r in runs.items()})}")
    if not runs["auto"]["losses"] or runs["auto"]["losses"] != runs["fixed"]["losses"]:
        bad.append(f"auto losses {runs['auto']['losses']} vs {route} "
                   f"{runs['fixed']['losses']}")
    if set(runs["auto"]["launches"]) != want or runs["auto"]["launches"] != \
            runs["fixed"]["launches"]:
        bad.append(f"auto launched {runs['auto']['launches']}, {route} "
                   f"{runs['fixed']['launches']}, expected the kernels {sorted(want)}")
    if bad:
        raise AssertionError(f"autotune (c) on {route}: " + "; ".join(bad))
    return {"route": list(route),
            **{k: {x: v[x] for x in ("losses", "launches", "seconds", "warm_step_ms")}
               for k, v in runs.items()}}


def autotune_serve(torch, smi, dev, model_dir: Path, cache_path: Path, tuned: dict,
                   launches: dict) -> dict:
    """(d) an engine under ``pallas_impl="auto"`` per table dtype, batch
    1 and 64 at width 200: every shape's provenance says cached with the
    tuned schedule, and its answers equal the fixed route's bitwise."""
    from code2vec_tpu_torch.models.code2vec import Code2Vec, route_config
    from code2vec_tpu_torch.ops import autotune as at
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.predict import Predictor
    from code2vec_tpu_torch.serve.engine import ServingEngine

    c = TOP11
    kind = at.device_kind(dev)
    rng = np.random.default_rng(11)
    out, bad = {}, []
    for dt in ("f32", "int8"):
        # the engine's warm runs and answers count; the fixed-route
        # reference forward below is reset away before the next shape
        reset_launch_counts()
        predictor = Predictor(str(model_dir), str(model_dir / "terminal_idxs.txt"),
                              str(model_dir / "path_idxs.txt"), table_dtype=dt, device=dev,
                              pallas_impl="auto", autotune_cache=str(cache_path))
        engine = ServingEngine(predictor, batch_sizes=AT_SERVE_BATCHES, ladder=(BAG,))
        records = {(r["batch"], r["width"]): r for r in engine.prepare()}
        for b in AT_SERVE_BATCHES:
            rec = records[(b, BAG)]
            key = at.ShapeKey(kind, b, BAG, c["terminal_embed_size"], c["path_embed_size"],
                              c["encode_size"], dt).cache_key()
            want = {**tuned[key]["schedule"], "source": "cache"}
            if not rec["schedule_cached"] or rec["schedule"] != want:
                bad.append(f"{key}: provenance {rec['schedule']} cached "
                           f"{rec['schedule_cached']}, tuned {want}")
                continue
            lengths = rng.integers(1, BAG + 1, b)
            ids = np.zeros((3, b, BAG), np.int32)
            for i, n in enumerate(lengths):
                ids[0, i, :n] = rng.integers(1, c["terminal_count"], n)
                ids[1, i, :n] = rng.integers(1, c["path_count"], n)
                ids[2, i, :n] = rng.integers(0, c["terminal_count"], n)
            got = engine.run(*ids)
            torch.cuda.synchronize()
            add_counts(launches, launch_counts())
            with torch.device("meta"):
                fixed = Code2Vec(route_config(predictor.config,
                                              at.KernelSchedule.from_dict(rec["schedule"])))
            fixed.load_state_dict(predictor.model.state_dict(), assign=True)
            fixed.eval()
            with torch.inference_mode():
                ref = fixed(*(torch.from_numpy(x).to(dev) for x in ids),
                            quant_tables=predictor.quant_tables)
            torch.cuda.synchronize()
            reset_launch_counts()
            same = all(np.array_equal(g, r.cpu().numpy()) for g, r in zip(got, ref))
            if not same:
                bad.append(f"{key}: the engine's answers differ from {rec['schedule']['impl']}"
                           f"/{rec['schedule']['softmax']}'s")
            out[key] = {"schedule": rec["schedule"], "bitwise": same,
                        "warm_ms": rec["compile_ms"]}
            print(f"autotune (d) {key}: provenance cached {rec['schedule']['impl']}/"
                  f"{rec['schedule']['softmax']}, {b} rows bitwise the fixed route's: {same} "
                  f"[{smi}]", flush=True)
        torch.cuda.synchronize()
        add_counts(launches, launch_counts())  # nonzero only if a shape failed its provenance
        del engine, predictor
    if bad:
        raise AssertionError("autotune (d): " + "; ".join(bad))
    return out


def autotune_search_ann(torch, smi, dev, index, cache_path: Path, launches: dict) -> dict:
    """(e) a searcher built with the cache runs K5 and short-lists what the
    default searcher does."""
    from code2vec_tpu_torch.ann.index import AnnSearcher
    from code2vec_tpu_torch.ops import autotune as at
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    tuned = AnnSearcher(index, n_probe=ANN_PROBE, shortlist=ANN_SHORTLIST, device=dev,
                        cache=at.ScheduleCache(str(cache_path)))
    default = AnnSearcher(index, n_probe=ANN_PROBE, shortlist=ANN_SHORTLIST, device=dev,
                          schedule=at.default_lut_schedule(dev))
    rng = np.random.default_rng(5)
    queries = rng.normal(size=(ANN_QUERIES, index.meta["dim"])).astype(np.float32)
    reset_launch_counts()
    got = [tuned.search(q[None]) for q in queries]
    torch.cuda.synchronize()
    counts = launch_counts()
    add_counts(launches, counts)
    want = [default.search(q[None]) for q in queries]
    same = all(same_shortlist(a[0], a[1], b[0], b[1]) for a, b in zip(got, want))
    desc = tuned.describe()
    print(f"autotune (e): the searcher's schedule {desc['schedule']}, K5 launches "
          f"{counts.get('lut_score', 0)} over {ANN_QUERIES} queries, shortlists equal to the "
          f"default searcher's: {same} [{smi}]", flush=True)
    if desc["schedule"]["source"] != "cache" or desc["schedule"]["impl"] != "pallas" \
            or counts.get("lut_score", 0) < 1 or not same:
        raise AssertionError(f"autotune (e): schedule {desc['schedule']}, launches {counts}, "
                             f"same shortlists {same}")
    return {"schedule": desc["schedule"], "launches": counts.get("lut_score", 0)}


def phase_autotune(torch, smi, dev, tmp: Path, model_dir: Path, elastic) -> dict:
    """The autotuner on the card at the top11 widths: (a) tune the six
    forward keys and the retrieval index's LUT key into a fresh cache, (b)
    the CLI's ``--expect-cached`` rerun, (c) one epoch of the train recipe
    under ``--pallas_impl auto`` against the fixed route, (d) engines under
    ``auto`` (f32 and int8 tables), (e) a searcher built with the cache.
    Needs the retrieval phase's index in ``model_dir``; the train corpus
    comes from train_elastic (written here when that phase did not run)."""
    import shutil

    from code2vec_tpu_torch.ann.index import load_index
    from code2vec_tpu_torch.ops import autotune as at

    root = tmp / "autotune"
    root.mkdir(parents=True, exist_ok=True)
    cache_path = root / "schedules.json"
    index_path = model_dir / "ann.index"
    if not index_path.exists():
        raise RuntimeError(f"{index_path} is missing: run the retrieval phase first")
    index, _, _ = load_index(str(index_path))
    meta = index.meta
    lut_key = at.LutShapeKey(at.device_kind(dev), meta["m"], meta["n_list"], meta["capacity"],
                             ANN_SHORTLIST)
    corpus = (elastic or {}).get("corpus_paths")
    if corpus is None:
        raw, _ = train_corpus()
        corpus = write_raw_corpus(raw, root / "corpus")
    launches: dict = {}
    seconds = {}
    out = {}
    try:
        for part, fn, args in (
                ("a", autotune_search, (torch, smi, dev, cache_path, lut_key, launches)),
                ("b", autotune_expect_cached, (cache_path, lut_key)),
        ):
            t0 = time.perf_counter()
            out[part] = fn(*args)
            seconds[part] = time.perf_counter() - t0
        train_key = next(k for k in out["a"]["keys"] if f"|b={TRAIN_BATCH}|" in k)
        for part, fn, args in (
                ("c", autotune_train, (torch, smi, corpus, root, cache_path,
                                       out["a"]["keys"][train_key]["schedule"], launches)),
                ("d", autotune_serve, (torch, smi, dev, model_dir, cache_path,
                                       out["a"]["keys"], launches)),
                ("e", autotune_search_ann, (torch, smi, dev, index, cache_path, launches)),
        ):
            t0 = time.perf_counter()
            out[part] = fn(*args)
            seconds[part] = time.perf_counter() - t0
    finally:
        at.reset_cache()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = seconds
    out["launches"] = launches
    print(f"autotune seconds per part {json.dumps({k: round(v, 2) for k, v in seconds.items()})}"
          f"; launches {json.dumps(launches)} [{smi}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: bucketed and long-bag training
# ---------------------------------------------------------------------------

# long-bag route -> (config updates, the launch keys its training run must show)
LONGBAG_ROUTES = {
    "plain": ({}, ()),
    # K3 at the base rungs, K4 online above max_path_length
    "fused": (kernel_route("fused"), ("fused_f32_masked", "online_f32_masked")),
    # K4 two_pass at every width
    "fused_two_pass": (dict(kernel_route("fused"), pallas_softmax="two_pass"),
                       ("two_pass_f32_masked",)),
}
LONGBAG_REQUEST_LENGTHS = (2000, 5, 60, 200, 350, 900, 1500, 2000, 3000, 40, 120, 600, 2000, 10,
                           250, 1100)


def split_batches(data, config, ladder, bag_width):
    """Train and test batches an epoch of ``make_batch_source`` feeds, per
    ladder width (the split's counts capped at ``bag_width``)."""
    from code2vec_tpu_torch.data.pipeline import bucket_batch_counts, split_items

    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(config.random_seed))
    counts = np.minimum(np.diff(data.row_splits), bag_width)
    return tuple(bucket_batch_counts(counts[idx], ladder, config.batch_size)
                 for idx in (train_idx, test_idx))


def check_every_width(label, counts, key, per_width, epochs):
    """A kernel launched once for every batch of every ladder width its
    route's forward takes: ``per_width`` batches an epoch, none zero."""
    want = int(per_width.sum()) * epochs
    if (per_width == 0).any() or counts.get(key, 0) != want:
        raise AssertionError(f"train {label}: {key} launched {counts.get(key, 0)} times, "
                             f"want one per batch ({want}, per width {per_width.tolist()})")


def same_losses(label, runs):
    """Every route's per-epoch train losses within rtol 1e-4 of the first's
    (one keep-mask stream on every route)."""
    base = [m["train_loss"] for m in next(iter(runs.values()))["epochs"]]
    for route, run in runs.items():
        got = [m["train_loss"] for m in run["epochs"]]
        if not np.allclose(got, base, rtol=1e-4, atol=0):
            raise AssertionError(f"{label} {route}: train losses {got} vs {base}")


def phase_train_bucketed(torch, smi, dev, tmp: Path) -> dict:
    """Bucketed training (bench.py's --bucket-ab corpus) and long-bag
    training (its --longbag-ab lengths) at the top11 widths through each
    route, a differential at three widths and the long-bag dir served."""
    from code2vec_tpu_torch.data.pipeline import build_method_epoch, iter_bucketed_batches
    from code2vec_tpu_torch.formats.vocab_io import write_vocab_from_names
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import resolve_ladder

    out = {}
    # 1. bucketed: 30,720 methods, mean 60, lognormal sigma 1.0, max 400
    # (bench.py:875-893), batch 1024, bag 200, the derived ladder
    t0 = time.perf_counter()
    _, data = train_corpus(n_methods=30_720, mean_contexts=60.0, length_sigma=1.0,
                           max_contexts=2 * BAG)
    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                         max_epoch=2, random_seed=0, print_sample_cycle=0, bucketed=True)
    ladder, bag_width = resolve_ladder(config, data)
    per_width, test_width = split_batches(data, config, ladder, bag_width)
    print(f"bucketed corpus: {data.n_items} methods, {data.n_contexts} contexts, made in "
          f"{time.perf_counter() - t0:.1f}s; ladder {list(ladder)}, train batches per width "
          f"{per_width.tolist()}, test {test_width.tolist()}", flush=True)
    runs = {}
    for route, keys in TRAIN_ROUTES.items():
        runs[route] = run = train_route(
            torch, smi, dev, data, config.with_updates(**kernel_route(route)),
            f"bucketed {route}", keys)
        for key in keys:
            check_every_width(f"bucketed {route}", run["launches"], key,
                              per_width + test_width * (key == "pool"), 2)
    same_losses("bucketed", runs)
    out["bucketed"] = {"ladder": list(ladder), "train_batches_per_width": per_width.tolist(),
                       "routes": runs}
    del data

    # 2. long bags: 10,240 methods, mean 60, sigma 1.2, max 3,200 (bench.py:1077-1097),
    # batch 256, bag 200, --max_contexts 0
    t0 = time.perf_counter()
    raw, data = train_corpus(n_methods=10_240, mean_contexts=60.0, length_sigma=1.2,
                             max_contexts=16 * BAG)
    config = config.with_updates(batch_size=LONGBAG_BATCH, max_contexts=0)
    ladder, bag_width = resolve_ladder(config, data)
    per_width, test_width = split_batches(data, config, ladder, bag_width)
    base = ladder.index(BAG) + 1
    print(f"long-bag corpus: {data.n_items} methods, {data.n_contexts} contexts (longest "
          f"{int(np.diff(data.row_splits).max())}), made in {time.perf_counter() - t0:.1f}s; "
          f"ladder {list(ladder)} (long rungs {list(ladder[base:])}), train batches per width "
          f"{per_width.tolist()}", flush=True)
    if bag_width != ladder[-1] or bag_width < int(np.diff(data.row_splits).max()):
        raise AssertionError(f"long-bag ladder {ladder} does not cover every bag")
    model_dir = tmp / "trained_longbag"
    runs = {}
    for route, (kw, keys) in LONGBAG_ROUTES.items():
        runs[route] = run = train_route(
            torch, smi, dev, data, config.with_updates(**kw), f"long-bag {route}", keys,
            str(model_dir) if route == "fused" else None)
        if any(m["truncated_context_fraction"] != 0.0 for m in run["epochs"]):
            raise AssertionError(f"long-bag {route} truncated contexts: {run['epochs']}")
    check_every_width("long-bag fused", runs["fused"]["launches"], "fused_f32_masked",
                      per_width[:base], 2)
    check_every_width("long-bag fused", runs["fused"]["launches"], "online_f32_masked",
                      per_width[base:], 2)
    check_every_width("long-bag fused_two_pass", runs["fused_two_pass"]["launches"],
                      "two_pass_f32_masked", per_width, 2)
    same_losses("long-bag", runs)
    out["longbag"] = {"ladder": list(ladder), "train_batches_per_width": per_width.tolist(),
                      "routes": runs}

    # 3. the differential, dropout 0: one batch at the narrowest rung, one at
    # the training bag and one at the widest long rung
    epoch = build_method_epoch(data, np.arange(data.n_items), bag_width,
                               np.random.default_rng(1))
    wanted, batches = (ladder[0], BAG, ladder[-1]), {}
    for batch in iter_bucketed_batches(epoch, ladder, LONGBAG_BATCH):
        batches.setdefault(batch["starts"].shape[1], batch)
    del epoch
    out["differential"] = train_differential(
        torch, dev, data, config, [batches[w] for w in wanted],
        {"plain": {}, **{r: kernel_route(r) for r in ("pool_only", "gather_split", "fused")},
         "fused_two_pass": LONGBAG_ROUTES["fused_two_pass"][0]})

    # 4. the long-bag fused dir served as it stands: a 2,000-context request
    # is answered through K4
    write_vocab_from_names(model_dir / "terminal_idxs.txt", raw.terminal_names)
    write_vocab_from_names(model_dir / "path_idxs.txt", raw.path_names)
    meta = json.loads((model_dir / "model_meta.json").read_text())
    if meta["bucket_ladder"] != list(ladder):
        raise AssertionError(f"recorded ladder {meta['bucket_ladder']}, trained on {ladder}")
    requests = make_requests(len(LONGBAG_REQUEST_LENGTHS), seed=29,
                             lengths=np.asarray(LONGBAG_REQUEST_LENGTHS))
    served = serve_route(torch, model_dir, "fused", "f32", requests, smi, dev,
                         ladder=tuple(meta["bucket_ladder"]))
    if served["launches"].get("online_f32", 0) < 1:
        raise AssertionError("serving the long-bag dir never launched K4")
    out["served"] = served
    return out


# ---------------------------------------------------------------------------
# phase 9: bf16 training
# ---------------------------------------------------------------------------

# route -> the launch keys its bf16 training run must show once per train batch
TRAIN_BF16_ROUTES = {
    "plain": (),
    "pool_only": ("pool_bwd_bf16",),
    "gather_split": ("gather_split_bf16_masked",),
    "fused": ("fused_f32_masked",),
}


def check_bf16_checkpoint(torch, dev, data, config, model_dir: Path) -> dict:
    """The fused run's best checkpoint: its first moments are bf16, it
    restores into a bf16-mu optimizer (the moments bit for bit) and a
    float32 one refuses it with the flag that resumes it."""
    from code2vec_tpu_torch.checkpoint import restore_checkpoint, slot_path
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.loop import model_config_from
    from code2vec_tpu_torch.train.step import make_optimizer

    saved = torch.load(slot_path(str(model_dir), "best"), map_location="cpu", weights_only=False)
    moments = [s["exp_avg"] for s in saved["optimizer"]["state"].values()]
    if saved["meta"]["adam_mu_dtype"] != "bfloat16" or not moments or \
            any(m.dtype != torch.bfloat16 for m in moments):
        raise AssertionError("the bf16 run's checkpoint does not hold bf16 first moments")
    with torch.device(dev):
        model = Code2Vec(model_config_from(config, data))
    opt = make_optimizer(model, config)
    meta = restore_checkpoint(str(model_dir), model, opt, np.random.default_rng(0),
                              model_config_from(config, data).vocab_pad_multiple)
    restored = [opt.state[p]["exp_avg"] for p in model.parameters()]
    if meta is None or not all(r.dtype == torch.bfloat16 and torch.equal(r.cpu(), m)
                               for r, m in zip(restored, moments)):
        raise AssertionError("restoring the bf16 checkpoint lost its first moments")
    try:
        restore_checkpoint(str(model_dir), model, make_optimizer(
            model, config.with_updates(adam_mu_dtype="float32")), np.random.default_rng(0),
            model_config_from(config, data).vocab_pad_multiple)
    except ValueError as err:
        if "--adam_mu_dtype bfloat16" not in str(err):
            raise
        refusal = str(err)
    else:
        raise AssertionError("a float32-mu optimizer restored the bf16 checkpoint")
    print(f"bf16 checkpoint: {len(moments)} bf16 first moments restored bit for bit; "
          f"under float32: {refusal}", flush=True)
    return {"moments": len(moments), "refusal": refusal}


def phase_train_bf16(torch, smi, dev, tmp: Path, f32_train) -> dict:
    """The train phase's recipe under --compute_dtype bfloat16
    --adam_mu_dtype bfloat16 through each route, beside the f32 numbers."""
    from code2vec_tpu_torch.data.pipeline import build_method_epoch, iter_batches, split_items
    from code2vec_tpu_torch.train.config import TrainConfig

    _, data = train_corpus()
    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                         max_epoch=2, random_seed=0, print_sample_cycle=0,
                         compute_dtype="bfloat16", adam_mu_dtype="bfloat16")
    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(config.random_seed))
    n_train = -(-len(train_idx) // TRAIN_BATCH)
    n_test = -(-len(test_idx) // TRAIN_BATCH)
    out = {"routes": {}}
    model_dir = tmp / "trained_bf16"
    for route, keys in TRAIN_BF16_ROUTES.items():
        run = out["routes"][route] = train_route(
            torch, smi, dev, data, config.with_updates(**kernel_route(route)), f"bf16 {route}",
            keys, str(model_dir) if route == "fused" else None)
        want = dict.fromkeys(keys, n_train * config.max_epoch)
        if route == "pool_only":
            want["pool_bf16"] = (n_train + n_test) * config.max_epoch
        got = {k: run["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"bf16 {route}: launches {run['launches']}, want {want}")
        if not all(m["f1"] > 0.0 for m in run["epochs"]):
            raise AssertionError(f"bf16 {route}: F1 {[m['f1'] for m in run['epochs']]}")
        f32 = ((f32_train or {}).get("routes") or {}).get(route)
        for i, m in enumerate(run["epochs"]):
            ref = f32["epochs"][i] if f32 else None
            print(f"train bf16 vs f32 {route} epoch {i}: steps/s {m['steps_per_s']:.3f} vs "
                  f"{ref['steps_per_s'] if ref else float('nan'):.3f}, real contexts/s "
                  f"{m['contexts_per_s']:.1f} vs {ref['contexts_per_s'] if ref else float('nan'):.1f}"
                  f", subtoken f1 {m['f1']:.6f} vs {ref['f1'] if ref else float('nan'):.6f}, peak "
                  f"device memory {run['peak_bytes'] / 2**30:.3f} vs "
                  f"{f32['peak_bytes'] / 2**30 if f32 else float('nan'):.3f} GiB [{smi}]",
                  flush=True)
    out["checkpoint"] = check_bf16_checkpoint(torch, dev, data, config, model_dir)

    # the differential, dropout 0: a batch at each width
    rng = np.random.default_rng(1)
    items = rng.permutation(data.n_items)[:TRAIN_BATCH]
    batches = [next(iter_batches(build_method_epoch(data, items, width, rng), TRAIN_BATCH))
               for width in BF16_DIFF_WIDTHS]
    out["differential"] = train_differential(
        torch, dev, data, config, batches,
        {route: kernel_route(route) for route in TRAIN_BF16_ROUTES})
    out["breakdown"] = step_breakdown(torch, dev, data, config, smi, label="bf16 ")
    return out


# ---------------------------------------------------------------------------
# phase 10: lazy table training (--table_update lazy)
# ---------------------------------------------------------------------------

# bf16 compute + bf16 first moments, lazily: route -> its launch keys
TRAIN_LAZY_BF16_ROUTES = {"plain": (), "fused": ("fused_f32_masked",)}
# the profiler ops that form a dense [V, E] table gradient
DENSE_GRAD_OPS = ("aten::zero_", "aten::zeros", "aten::index_put_", "aten::index_put",
                  "aten::index_add_")


def synced_at(err: BaseException) -> str:
    """Where a sync-debug error was raised: the innermost frame of the port
    (or of this script) in its traceback, with the error's first line."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if "code2vec_tpu_torch" in f.filename or f.filename.endswith("chip_smoke.py")]
    where = f"{Path(frames[-1].filename).name}:{frames[-1].lineno} {frames[-1].line}" \
        if frames else "?"
    return f"{where}: {str(err).splitlines()[0]}"


def check_lazy_step(torch, dev, data, config, host_batches, route, smi) -> dict:
    """On one route, lazily: (1) a warm step's table optimizer under
    ``torch.cuda.set_sync_debug_mode("error")`` must not sync, and the
    whole next step is tried the same way (where it syncs is reported, not
    failed); (2) the profiler's op list of a step holds no embedding
    backward and no ``[V, E]``-sized zero / ``index_put`` / ``index_add_``,
    and the tables' ``.grad`` stay None (the dense step on the plain route
    shows the embedding backward, so the check can see one)."""
    from torch.profiler import ProfilerActivity, profile

    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.loop import class_weights_from, model_config_from
    from code2vec_tpu_torch.train.step import (
        lazy_forward_backward,
        make_optimizer,
        to_device,
        train_step,
    )

    batches = [to_device(b, dev) for b in host_batches]
    weights = class_weights_from(config, data, dev)
    table_shapes = {(len(data.terminal_vocab), config.terminal_embed_size),
                    (len(data.path_vocab), config.path_embed_size)}
    out = {}
    for update in ("lazy", "dense") if route == "plain" else ("lazy",):
        with torch.device(dev):
            model = Code2Vec(model_config_from(config.with_updates(**kernel_route(route)), data))
        model.seed_dropout(0)
        opt = make_optimizer(model, config.with_updates(table_update=update))
        train_step(model, opt, batches[0], weights)
        if update == "lazy":
            opt.zero_grad(set_to_none=True)
            _, table_grads = lazy_forward_backward(model, batches[1], weights)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                opt.step(table_grads)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                train_step(model, opt, batches[2], weights)
                out["whole_step_sync"] = None
            except RuntimeError as err:
                if "synchroniz" not in str(err):  # only a sync is reported, not failed
                    raise
                out["whole_step_sync"] = synced_at(err)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            train_step(model, opt, batches[3], weights)
            torch.cuda.synchronize()
        dense_ops = sorted({
            e.name for e in prof.events()
            if e.name == "aten::embedding_dense_backward"
            or (e.name in DENSE_GRAD_OPS
                and any(tuple(sh) in table_shapes for sh in (e.input_shapes or [])))})
        out[f"{update}_dense_grad_ops"] = dense_ops
        grads = [model.terminal_embedding.weight.grad, model.path_embedding.weight.grad]
        if update == "lazy" and (dense_ops or any(g is not None for g in grads)):
            raise AssertionError(f"lazy {route}: a dense table gradient was formed: {dense_ops}, "
                                 f".grad {[g is not None for g in grads]}")
        if update == "dense" and "aten::embedding_dense_backward" not in dense_ops:
            raise AssertionError(f"the dense step's op list shows no embedding backward: "
                                 f"{dense_ops}")
        del model, opt
    print(f"lazy {route}: the table optimizer's step ran under sync debug mode 'error' with "
          f"no sync; the whole step: {out['whole_step_sync'] or 'no sync'}; dense table "
          f"gradient ops in a lazy step: {out['lazy_dense_grad_ops'] or 'none'}"
          + (f" (dense step: {out['dense_dense_grad_ops']})" if route == "plain" else "")
          + f" [{smi}]", flush=True)
    return out


def check_sparse_adam(torch, dev, data, config, host_batches, smi) -> dict:
    """Two ``LazyTableAdam`` steps on the card, on the per-slot gradients
    of two batches at the config's widths, against ``torch.optim.SparseAdam``
    on the card stepping copies of the same tables with the same gradients
    as sparse tensors: every row of both tables and both moments within
    rtol 1e-5 and 1e-6 of each tensor's largest element (both sum a row's
    slots on the card, in their own orders); the rows neither step touched
    equal bit for bit."""
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.loop import class_weights_from, model_config_from
    from code2vec_tpu_torch.train.step import lazy_forward_backward, to_device
    from code2vec_tpu_torch.train.table_opt import LazyTableAdam

    weights = class_weights_from(config, data, dev)
    with torch.device(dev):
        model = Code2Vec(model_config_from(config.with_updates(dropout_prob=0.0), data))
    grads = [lazy_forward_backward(model, to_device(b, dev), weights)[1]
             for b in host_batches[:2]]
    tables = [model.terminal_embedding.weight, model.path_embedding.weight]
    lazy_tables = [t.detach().clone() for t in tables]
    sparse_tables = [t.detach().clone().requires_grad_() for t in tables]
    del model
    betas = (config.beta_min, config.beta_max)
    lazy = LazyTableAdam(lazy_tables, torch.optim.Adam([torch.zeros(1, device=dev)]),
                         lr=config.lr, betas=betas, eps=1e-8)
    sparse = torch.optim.SparseAdam(sparse_tables, lr=config.lr, betas=betas, eps=1e-8)
    worst = {}
    touched = [torch.zeros(t.shape[0], dtype=torch.bool, device=dev) for t in tables]
    for step, table_grads in enumerate(grads):
        lazy.step(table_grads)
        for t, (ids, slots) in zip(sparse_tables, table_grads):
            t.grad = torch.sparse_coo_tensor(ids.long()[None], slots, t.shape,
                                            check_invariants=True)
        sparse.step()
        for name, a, b, (ids, _), seen in zip(("terminal", "path"), lazy_tables,
                                              sparse_tables, table_grads, touched):
            seen[ids.long()] = True
            untouched = ~seen
            for what, x, y in (("rows", a, b.detach()),
                               ("mu", lazy.state[a]["exp_avg"], sparse.state[b]["exp_avg"]),
                               ("nu", lazy.state[a]["exp_avg_sq"],
                                sparse.state[b]["exp_avg_sq"])):
                key = f"{name} {what}"
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6 * y.abs().max().item(),
                                           msg=f"LazyTableAdam vs SparseAdam, step {step}: {key}")
                if not torch.equal(x[untouched], y[untouched]):
                    raise AssertionError(f"step {step}: {key}: an untouched row differs")
                worst[key] = max(worst.get(key, 0.0), (x - y).abs().max().item())
    print(f"LazyTableAdam vs torch.optim.SparseAdam on the card, 2 steps over "
          f"{[tuple(t.shape) for t in lazy_tables]}: max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" [{smi}]", flush=True)
    return worst


def beside(label, run, ref, smi, ref_name="dense",
           keys=(("train_loss", ".6f"), ("f1", ".6f"), ("steps_per_s", ".3f"),
                 ("contexts_per_s", ".1f"))):
    """Each epoch of ``run`` beside the same epoch of ``ref`` (the run of
    the same recipe named ``ref_name``): ``keys`` and the peak memory."""
    nan = float("nan")
    for i, m in enumerate(run["epochs"]):
        r = ref["epochs"][i] if ref else {}
        pairs = ", ".join(f"{key} {m[key]:{fmt}} vs {r.get(key, nan):{fmt}}" for key, fmt in keys)
        print(f"train {label} vs {ref_name} epoch {i}: {pairs}, peak device memory "
              f"{run['peak_bytes'] / 2**30:.3f} vs "
              f"{ref['peak_bytes'] / 2**30 if ref else nan:.3f} GiB [{smi}]", flush=True)


def phase_train_lazy(torch, smi, dev, dense_f32, dense_bucketed, dense_bf16) -> dict:
    """The train phase's recipe with --table_update lazy through each route
    (f32; bf16 compute + bf16 first moments on plain and fused), beside the
    dense runs; the lazy differential, the sync and dense-gradient checks,
    the step breakdown beside the dense one, and one long-bag epoch."""
    from code2vec_tpu_torch.data.pipeline import build_method_epoch, iter_batches, split_items
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import resolve_ladder

    _, data = train_corpus()
    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                         max_epoch=2, random_seed=0, print_sample_cycle=0, table_update="lazy")
    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(config.random_seed))
    n_train = -(-len(train_idx) // TRAIN_BATCH)
    n_test = -(-len(test_idx) // TRAIN_BATCH)
    bf16 = config.with_updates(compute_dtype="bfloat16", adam_mu_dtype="bfloat16")
    out = {"routes": {}, "bf16_routes": {}}
    for runs, cfg, routes, dense, tag in (
            (out["routes"], config, TRAIN_ROUTES, dense_f32, "lazy"),
            (out["bf16_routes"], bf16, TRAIN_LAZY_BF16_ROUTES, dense_bf16, "lazy bf16")):
        for route, keys in routes.items():
            run = runs[route] = train_route(torch, smi, dev, data,
                                            cfg.with_updates(**kernel_route(route)),
                                            f"{tag} {route}", keys)
            want = dict.fromkeys(keys, n_train * config.max_epoch)
            if route == "pool_only":
                want["pool"] = (n_train + n_test) * config.max_epoch
            got = {k: run["launches"].get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"{tag} {route}: launches {run['launches']}, want {want}")
            if not all(m["f1"] > 0.0 for m in run["epochs"]):
                raise AssertionError(f"{tag} {route}: F1 {[m['f1'] for m in run['epochs']]}")
            beside(f"{tag} {route}", run, ((dense or {}).get("routes") or {}).get(route), smi)

    # the differential, dropout 0: 3 lazy steps a route from one set of weights
    rng = np.random.default_rng(1)
    items = rng.permutation(data.n_items)[:3 * TRAIN_BATCH]
    host = list(iter_batches(build_method_epoch(data, items, BAG, rng), TRAIN_BATCH))
    out["differential"] = train_differential(
        torch, dev, data, config, host, {route: kernel_route(route) for route in TRAIN_ROUTES})
    out["sparse_adam"] = check_sparse_adam(torch, dev, data, config, host, smi)
    host = host + host[:1]
    out["checks"] = {route: check_lazy_step(torch, dev, data, config, host, route, smi)
                     for route in TRAIN_ROUTES}
    out["breakdown"] = step_breakdown(torch, dev, data, config, smi, label="lazy ")
    out["breakdown_bf16"] = step_breakdown(torch, dev, data, bf16, smi, label="lazy bf16 ",
                                           routes=TRAIN_LAZY_BF16_ROUTES)
    del data

    # long bags, lazily: one epoch of the long-bag recipe on the fused route
    _, data = train_corpus(n_methods=10_240, mean_contexts=60.0, length_sigma=1.2,
                           max_contexts=16 * BAG)
    config = config.with_updates(batch_size=LONGBAG_BATCH, max_contexts=0, bucketed=True,
                                 max_epoch=1)
    ladder, bag_width = resolve_ladder(config, data)
    per_width, _ = split_batches(data, config, ladder, bag_width)
    base = ladder.index(BAG) + 1
    kw, keys = LONGBAG_ROUTES["fused"]
    run = out["longbag"] = train_route(torch, smi, dev, data, config.with_updates(**kw),
                                       "lazy long-bag fused", keys)
    check_every_width("lazy long-bag fused", run["launches"], "fused_f32_masked",
                      per_width[:base], 1)
    check_every_width("lazy long-bag fused", run["launches"], "online_f32_masked",
                      per_width[base:], 1)
    if any(m["truncated_context_fraction"] != 0.0 for m in run["epochs"]):
        raise AssertionError(f"lazy long-bag truncated contexts: {run['epochs']}")
    beside("lazy long-bag fused", run,
           ((dense_bucketed or {}).get("longbag") or {}).get("routes", {}).get("fused"), smi)
    return out


# ---------------------------------------------------------------------------
# phase 11: device-resident epochs (--device_epoch)
# ---------------------------------------------------------------------------

# route -> {launch key: the passes that launch it once a batch}
DEVICE_ROUTES = {
    "plain": {},
    "pool_only": {"pool": ("train", "eval"), "pool_bwd": ("train",)},
    "gather_split": {"gather_split_masked": ("train",), "gather_split": ("eval",)},
    "fused": {"fused_f32_masked": ("train",), "fused_f32": ("eval",)},
}


def device_launches(label, run, keys, n_train, n_test, epochs):
    """Each kernel of ``keys`` launched once for every batch of the passes
    that run it: ``n_train`` / ``n_test`` batches an epoch (scalars, or
    arrays per ladder width)."""
    for key, passes in keys.items():
        want = epochs * int(sum(np.sum(n) for p, n in (("train", n_train), ("eval", n_test))
                                if p in passes))
        got = run["launches"].get(key, 0)
        if got != want:
            raise AssertionError(f"device {label}: {key} launched {got} times, want one per "
                                 f"{'/'.join(passes)} batch ({want}): {run['launches']}")


def beside_host(label, run, ref, smi, ref_name="host"):
    """Each device-epoch epoch beside the same epoch of ``ref``, the
    host-fed run of the same recipe (or the run named ``ref_name``), then
    the staging."""
    beside(f"device {label}", run, ref, smi, ref_name,
           (("epoch_seconds", ".4f"), ("steps_per_s", ".3f"), ("contexts_per_s", ".1f"),
            ("train_loss", ".6f"), ("f1", ".6f")))
    first = run["epochs"][0]
    print(f"train device {label}: staged {first['staged_bytes']} bytes in "
          f"{first['stage_seconds']:.4f} s [{smi}]", flush=True)


def device_chunk_checks(torch, dev, data, config, route, smi, label="") -> dict:
    """On one route, dropout 0, from one set of seeded weights: (1) one
    chunk of the device runner against ``train_step`` fed the same sampled
    batches through the host feed (their numpy copies, ``to_device``),
    losses within rtol 1e-5; (2) the runner's next chunk, warm, under
    ``torch.cuda.set_sync_debug_mode("error")``: a sync fails the check and
    says where."""
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.device_epoch import EpochRunner, place_staged, sampler_generator
    from code2vec_tpu_torch.train.loop import class_weights_from, model_config_from, stage_host
    from code2vec_tpu_torch.train.step import StepTally, make_optimizer, to_device, train_step

    cfg = config.with_updates(dropout_prob=0.0, **kernel_route(route))
    base = Code2Vec(model_config_from(cfg, data))
    base.reset_parameters(torch.Generator().manual_seed(5))
    state = {k: v.to(dev) for k, v in base.state_dict().items()}
    del base
    models = []
    for _ in range(2):
        with torch.device(dev):
            model = Code2Vec(model_config_from(cfg, data))
        model.load_state_dict(state)
        models.append((model, make_optimizer(model, cfg)))
    weights = class_weights_from(cfg, data, dev)
    corpus = place_staged(stage_host(data, np.arange(data.n_items), np.random.default_rng(3)),
                          dev)
    runner = EpochRunner(weights, cfg.batch_size, cfg.max_path_length, 3,
                         shuffle_variable_ids=cfg.shuffle_variable_indexes)
    order = np.random.default_rng(4).permutation(corpus.n_items)
    (lo, nb, n_valid), (lo2, nb2, n_valid2), *_ = runner._chunk_plan(corpus.n_items)
    g = sampler_generator(0, dev)
    before = g.get_state()
    tally = StepTally(dev)
    runner.train_chunk(*models[0], corpus, order, lo, nb, n_valid, g, tally)
    g.set_state(before)
    batches = [{k: v.cpu().numpy() for k, v in b.items()}
               for b in runner._batches(corpus, order, lo, nb, n_valid, g)]
    host = [train_step(*models[1], to_device(b, dev), weights) for b in batches]
    device = torch.stack(tally.losses)
    torch.testing.assert_close(device, torch.stack(host), rtol=1e-5, atol=0)
    out = {"device_losses": device.tolist(), "host_losses": torch.stack(host).tolist()}

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.train_chunk(*models[0], corpus, order, lo2, nb2, n_valid2, g, StepTally(dev))
        out["chunk_sync"] = None
    except RuntimeError as err:
        if "synchroniz" not in str(err):
            raise
        out["chunk_sync"] = synced_at(err)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"device chunk {label or route}: {nb} steps, losses {[round(x, 6) for x in out['device_losses']]}"
          f" vs the host step {[round(x, 6) for x in out['host_losses']]}; a warm chunk of {nb2} "
          f"steps under sync debug mode 'error': {out['chunk_sync'] or 'no sync'} [{smi}]",
          flush=True)
    if out["chunk_sync"]:
        raise AssertionError(f"device chunk {label or route} synchronised: "
                             f"{out['chunk_sync']}")
    del models, corpus
    torch.cuda.empty_cache()
    return out


def device_epoch_split(torch, dev, data, config, smi) -> dict:
    """Where a device epoch's time goes (plain route, the run's recipe, one
    warm epoch first): the host's wall ms to enqueue the train pass, to its
    loss read, of the eval pass (to its read) and of the F1 on the host;
    and the device's busy ms over a train pass (``torch.profiler``: the
    union of its kernels' and copies' device intervals) against the
    unprofiled pass's wall."""
    from torch.profiler import ProfilerActivity, profile

    from code2vec_tpu_torch.data.pipeline import split_items
    from code2vec_tpu_torch.metrics import evaluate
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.loop import (
        class_weights_from,
        model_config_from,
        stage_device_epochs,
    )
    from code2vec_tpu_torch.train.step import StepTally, make_optimizer

    rng = np.random.default_rng(config.random_seed)
    train_idx, test_idx = split_items(data.n_items, rng)
    weights = class_weights_from(config, data, dev)
    feed = stage_device_epochs(config, data, train_idx, test_idx, rng, None, weights, dev)
    with torch.device(dev):
        model = Code2Vec(model_config_from(config, data))
    model.seed_dropout(0)
    opt = make_optimizer(model, config)
    runner = feed.runner
    runner.run_train_epoch(model, opt, feed.train, rng, feed.generator)
    runner.run_eval_epoch(model, feed.test, feed.generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tally = StepTally(dev)
    runner.train_epoch(model, opt, feed.train, rng, feed.generator, tally)
    t1 = time.perf_counter()
    tally.result()
    t2 = time.perf_counter()
    _, preds, _ = runner.run_eval_epoch(model, feed.test, feed.generator)
    t3 = time.perf_counter()
    evaluate(config.eval_method, feed.expected, preds, data.label_vocab)
    t4 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.run_train_epoch(model, opt, feed.train, rng, feed.generator)
        torch.cuda.synchronize()
    # the union of the kernels' (and copies') device intervals, in ms
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy /= 1e3
    out = {"train_enqueue_ms": (t1 - t0) * 1e3, "train_pass_ms": (t2 - t0) * 1e3,
           "eval_pass_ms": (t3 - t2) * 1e3, "f1_host_ms": (t4 - t3) * 1e3,
           "train_device_busy_ms": busy, "train_steps": len(tally.losses)}
    out["train_idle_share"] = 1.0 - busy / out["train_pass_ms"]
    print(f"device epoch split (plain, {out['train_steps']} train steps): train pass "
          f"{out['train_pass_ms']:.2f} ms host wall (enqueued in {out['train_enqueue_ms']:.2f}), "
          f"device busy {busy:.2f} ms of it (idle share {out['train_idle_share']:.3f}); eval "
          f"pass {out['eval_pass_ms']:.2f} ms; F1 on the host {out['f1_host_ms']:.2f} ms [{smi}]",
          flush=True)
    del model, opt, feed
    torch.cuda.empty_cache()
    return out


def phase_train_device(torch, smi, dev, host_train, host_bucketed, host_lazy) -> dict:
    """The train phase's recipe with --device_epoch on every route (also
    lazy bf16 on fused, sample_prefetch on plain and fused), bucketed device
    epochs on the --bucket-ab corpus (plain and fused), each beside its
    host-fed run; per route one chunk against the host step and a warm chunk
    under the sync debug mode."""
    from code2vec_tpu_torch.data.pipeline import split_items
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import resolve_ladder

    def host_run(runs, route):
        return ((runs or {}).get("routes") or {}).get(route)

    _, data = train_corpus()
    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                         max_epoch=2, random_seed=0, print_sample_cycle=0, device_epoch=True)
    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(config.random_seed))
    n_train, n_test = -(-len(train_idx) // TRAIN_BATCH), -(-len(test_idx) // TRAIN_BATCH)
    lazy_bf16 = dict(table_update="lazy", compute_dtype="bfloat16", adam_mu_dtype="bfloat16")
    runs = [(route, route, {}) for route in DEVICE_ROUTES] + [
        ("fused lazy bf16", "fused", lazy_bf16),
        ("plain sample_prefetch", "plain", {"sample_prefetch": True}),
        ("fused sample_prefetch", "fused", {"sample_prefetch": True})]
    out = {"routes": {}}
    for label, route, kw in runs:
        keys = DEVICE_ROUTES[route]
        run = out["routes"][label] = train_route(
            torch, smi, dev, data, config.with_updates(**kernel_route(route), **kw),
            f"device {label}", tuple(keys))
        device_launches(label, run, keys, n_train, n_test, config.max_epoch)
        if not all(m["f1"] > 0.0 for m in run["epochs"]):
            raise AssertionError(f"device {label}: F1 {[m['f1'] for m in run['epochs']]}")
        if "sample_prefetch" in kw:  # beside the same route's device run
            beside_host(label, run, out["routes"][route], smi, "unprefetched")
        elif "table_update" in kw:
            beside_host(label, run, ((host_lazy or {}).get("bf16_routes") or {}).get(route), smi)
        else:
            beside_host(label, run, host_run(host_train, route), smi)
    for route in ("plain", "fused"):  # the same batches, prefetched or not
        same_losses(f"device {route} sample_prefetch",
                    {"off": out["routes"][route], "on": out["routes"][f"{route} sample_prefetch"]})
    out["chunks"] = {route: device_chunk_checks(torch, dev, data, config, route, smi)
                     for route in DEVICE_ROUTES}
    out["split"] = device_epoch_split(torch, dev, data, config, smi)
    del data

    # bucketed device epochs on the --bucket-ab corpus, the derived ladder
    _, data = train_corpus(n_methods=30_720, mean_contexts=60.0, length_sigma=1.0,
                           max_contexts=2 * BAG)
    config = config.with_updates(bucketed=True)
    ladder, bag_width = resolve_ladder(config, data)
    per_width, test_width = split_batches(data, config, ladder, bag_width)
    out["bucketed"] = {"ladder": list(ladder), "routes": {}}
    for route in ("plain", "fused"):
        keys = DEVICE_ROUTES[route]
        run = out["bucketed"]["routes"][route] = train_route(
            torch, smi, dev, data, config.with_updates(**kernel_route(route)),
            f"device bucketed {route}", tuple(keys))
        device_launches(f"bucketed {route}", run, keys, per_width, test_width,
                        config.max_epoch)
        beside_host(f"bucketed {route}", run,
                    host_run((host_bucketed or {}).get("bucketed"), route), smi)
    same_losses("device bucketed", out["bucketed"]["routes"])
    return out


# ---------------------------------------------------------------------------
# phase 11b: the host feed and out-of-core corpora
# ---------------------------------------------------------------------------

# bench.py's training generator at 16,384 methods: cut from 32,768 to keep the whole
# script inside its window once the autotune phase runs
FEED_METHODS = 16_384
FEED_SLICE = 4_096  # the Python parser's slice
FEED_STREAM_CHUNK = 8_192
FEED_PROFILE_STEPS = 8
FEED_ROUTES = {  # route -> the kernels of its train and eval passes
    "fused": {"fused_f32_masked": ("train",), "fused_f32": ("eval",)},
    "pool_only": {"pool": ("train", "eval"), "pool_bwd": ("train",)},
}


def vm_rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def mapped_rss_bytes(path: Path) -> int:
    """The resident bytes of this process's mappings of ``path``
    (``/proc/self/smaps``): the container pages a gather has touched."""
    total, inside = 0, False
    with open("/proc/self/smaps") as f:
        for line in f:
            fields = line.split()
            if "-" in fields[0] and len(fields) >= 5 and ":" in fields[3]:
                inside = len(fields) >= 6 and fields[5] == str(path)
            elif inside and fields[0] == "Rss:":
                total += int(fields[1]) * 1024
    return total


def head_records(src: Path, dst: Path, n: int) -> None:
    """The first ``n`` records of a text corpus (records end at a blank line)."""
    with open(src, encoding="utf-8") as f, open(dst, "w", encoding="utf-8") as out:
        for line in f:
            out.write(line)
            if line == "\n":
                n -= 1
                if n == 0:
                    return


def batch_digest(batch) -> str:
    """A hash of one host batch's fields."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for key in ("ids", "starts", "paths", "ends", "labels", "example_mask"):
        h.update(np.ascontiguousarray(batch[key]).tobytes())
    return h.hexdigest()


def feed_digests(torch, dev, data, config) -> dict:
    """The digests of the batches ``train()`` is fed under ``config``, in
    stream order, from an untimed pass apart from the timed run: the same
    sources (``make_batch_source``, behind a ``FeedPool`` and
    ``ParallelFeed`` with workers), drawn from the run's generator in the
    run's order (the split, then each epoch's train and eval pass), through
    ``device_batches`` at the run's prefetch depth with each batch hashed as
    it is copied to the card, before the next pull can recycle it."""
    from code2vec_tpu_torch.data.parallel_feed import FeedPool, ParallelFeed
    from code2vec_tpu_torch.data.pipeline import make_batch_source, split_items
    from code2vec_tpu_torch.train.loop import resolve_ladder
    from code2vec_tpu_torch.train.prefetch import device_batches
    from code2vec_tpu_torch.train.step import to_device

    ladder, bag_width = resolve_ladder(config, data)
    rng = np.random.default_rng(config.random_seed)
    splits = split_items(data.n_items, rng)
    kw = dict(ladder=ladder, stream_chunk_items=config.stream_chunk_items,
              shuffle_variable_indexes=config.shuffle_variable_indexes)
    sources = [make_batch_source(data, idx, config.batch_size, bag_width, **kw)
               for idx in splits]
    digests = {"train": [], "eval": []}
    pool = None
    try:
        if config.feed_workers:
            pool = FeedPool(data, config.feed_workers, config.batch_size,
                            int(sources[0].ladder[-1]))
            sources = [ParallelFeed(source, pool) for source in sources]
        for _ in range(config.max_epoch):
            for split, source, shuffle in (("train", sources[0], True),
                                           ("eval", sources[1], False)):
                def copy(batch, out=digests[split]):
                    out.append(batch_digest(batch))
                    return to_device(batch, dev)

                with device_batches(source.batches(rng, shuffle=shuffle), copy,
                                    config.prefetch_batches, device=dev) as stream:
                    for _ in stream:
                        pass
    finally:
        if pool is not None:
            pool.close()
    torch.cuda.synchronize(dev)
    return digests


def feed_run(torch, smi, dev, data, config, label, route):
    """One timed ``train()`` run, then the digests of the stream it was fed
    (:func:`feed_digests`, untimed, so no hash lies inside an epoch or the
    profiled split): the train_route record with the digests, and each
    kernel of the route once for every train and eval batch."""
    run = train_route(torch, smi, dev, data, config, f"feed {label}",
                      tuple(FEED_ROUTES[route]))
    t0 = time.perf_counter()
    digests = feed_digests(torch, dev, data, config)
    n_train = sum(m["train_steps"] for m in run["epochs"])
    if len(digests["train"]) != n_train:
        raise AssertionError(f"feed {label}: the digest pass drew {len(digests['train'])} "
                             f"train batches, the run took {n_train} steps")
    run["digests"] = digests["train"] + digests["eval"]
    print(f"train feed {label}: {len(run['digests'])} batches hashed in an untimed pass of "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for key, passes in FEED_ROUTES[route].items():
        want = sum(len(digests[p]) for p in passes)
        if run["launches"].get(key, 0) != want:
            raise AssertionError(f"feed {label}: {key} launched {run['launches'].get(key, 0)} "
                                 f"times, want one per {'/'.join(passes)} batch ({want})")
    for m in run["epochs"]:
        print(f"train feed {label} epoch {m['epoch']}: split of {m['profiled_steps']} steps: "
              f"host_build {m['host_build_ms']:.3f} ms, h2d {m['h2d_ms']:.3f} ms, feed_wait "
              f"{m['feed_wait_ms']:.3f} ms, compute {m['compute_ms']:.3f} ms [{smi}]",
              flush=True)
    return run


def same_stream(label, run, ref):
    """The run fed the reference's batches (equal digests, in order) and its
    per-epoch losses are within rtol 1e-5 of the reference's."""
    if run["digests"] != ref["digests"]:
        first = next((i for i, (a, b) in enumerate(zip(run["digests"], ref["digests"]))
                      if a != b), min(len(run["digests"]), len(ref["digests"])))
        raise AssertionError(f"feed {label}: batch {first} differs from the synchronous "
                             f"stream's ({len(run['digests'])} vs {len(ref['digests'])} batches)")
    for key in ("train_loss", "test_loss"):
        got, want = [m[key] for m in run["epochs"]], [m[key] for m in ref["epochs"]]
        if not np.allclose(got, want, rtol=1e-5, atol=0):
            raise AssertionError(f"feed {label}: {key} {got} vs the synchronous {want}")
    print(f"train feed {label}: {len(run['digests'])} batch digests equal the synchronous "
          f"stream's; losses {[round(m['train_loss'], 6) for m in run['epochs']]} vs "
          f"{[round(m['train_loss'], 6) for m in ref['epochs']]}", flush=True)


def phase_train_feed(torch, smi, dev, tmp: Path, device_train) -> dict:
    """The host feed at the train recipe's widths on bench.py's training
    generator at 16,384 methods: the corpus written as text, converted to a
    CSR container by the port's tool, loaded through the native parser and
    then the cache; fused trained synchronously, with --prefetch_batches 2,
    with --feed_workers W, both, from the container (fixed, then bucketed)
    with both, streamed (--stream_chunk_items 8192) with prefetch; pool_only
    with both. Each run's batches equal its synchronous stream's."""
    import logging
    import os

    from code2vec_tpu_torch.data import reader
    from code2vec_tpu_torch.data.corpus_parser import parse_corpus_native
    from code2vec_tpu_torch.data.pipeline import make_batch_source, split_items
    from code2vec_tpu_torch.data.synth import SynthSpec, generate_corpus_files
    from code2vec_tpu_torch.tools.corpus_convert import text_to_csr
    from code2vec_tpu_torch.train.config import TrainConfig

    out = {}
    cores = len(os.sched_getaffinity(0))
    workers = max(1, min(4, cores - 1))
    out["cores"], out["workers"] = cores, workers
    print(f"train feed: {cores} usable cores, feed workers {workers}", flush=True)

    # the corpus: text, then the container
    root = tmp / "feed_corpus"
    t0 = time.perf_counter()
    spec = SynthSpec(n_methods=FEED_METHODS, n_terminals=360_631, n_paths=342_845,
                     n_labels=8_000, mean_contexts=120.0, length_sigma=0.6, max_contexts=400,
                     seed=0)
    paths = generate_corpus_files(root, spec)
    write_s = time.perf_counter() - t0
    text = Path(paths["corpus"])
    csr = root / "corpus.csr"
    t0 = time.perf_counter()
    n_records = text_to_csr(str(text), str(csr))
    convert_s = time.perf_counter() - t0
    out["corpus"] = {"methods": n_records, "text_bytes": text.stat().st_size,
                     "csr_bytes": csr.stat().st_size, "write_seconds": write_s,
                     "convert_seconds": convert_s}
    print(f"train feed corpus: {n_records} methods, text {text.stat().st_size} bytes written in "
          f"{write_s:.2f} s; converted to a CSR container of {csr.stat().st_size} bytes in "
          f"{convert_s:.2f} s (tools/corpus_convert.py)", flush=True)

    # the parsers: native on the whole corpus and on a slice, Python on the slice
    slice_path = root / "slice.txt"
    head_records(text, slice_path, FEED_SLICE)
    t0 = time.perf_counter()
    parse_corpus_native(str(text))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parse_corpus_native(str(slice_path))
    native_slice_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reader._parse_python(str(slice_path))
    python_slice_s = time.perf_counter() - t0
    out["parse"] = {"native_seconds": native_s, "native_slice_seconds": native_slice_s,
                    "python_slice_seconds": python_slice_s}
    print(f"train feed parse: native {native_s:.3f} s for {FEED_METHODS} methods; on a "
          f"{FEED_SLICE}-method slice native {native_slice_s:.4f} s, Python "
          f"{python_slice_s:.3f} s ({python_slice_s / native_slice_s:.1f}x)", flush=True)

    # load_corpus through the native parser (it must not fall back), then the cache
    fallbacks = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "native corpus parser unavailable" in record.getMessage():
                fallbacks.append(record.getMessage())

    catch = Catch()
    logging.getLogger(reader.__name__).addHandler(catch)
    try:
        args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
        t0 = time.perf_counter()
        parsed = reader.load_corpus(*args)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = reader.load_corpus(*args)
        cache_s = time.perf_counter() - t0
    finally:
        logging.getLogger(reader.__name__).removeHandler(catch)
    if fallbacks:
        raise AssertionError(f"the native parser fell back: {fallbacks}")
    for key in ("starts", "paths", "ends", "row_splits", "ids", "labels"):
        if not np.array_equal(getattr(parsed, key), getattr(data, key)):
            raise AssertionError(f"the cached corpus's {key} differs from the parsed one")
    del parsed
    mmap = reader.load_corpus(str(csr), paths["path_idx"], paths["terminal_idx"])
    if not mmap.mmap_backed or not np.array_equal(mmap.row_splits, data.row_splits):
        raise AssertionError("the container did not load mmap-backed as the text corpus")
    out["load"] = {"parse_and_cache_write_seconds": load_s, "cache_load_seconds": cache_s}
    print(f"train feed load: {data.n_items} methods, {data.n_contexts} contexts; native parse + "
          f"cache write {load_s:.3f} s, cache load {cache_s:.3f} s, no fallback", flush=True)

    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                         max_epoch=2, random_seed=0, print_sample_cycle=0,
                         profile_steps=FEED_PROFILE_STEPS)
    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(config.random_seed))
    print(f"train feed: {len(train_idx)} train / {len(test_idx)} test methods, "
          f"{-(-len(train_idx) // TRAIN_BATCH)} train batches an epoch at a fixed bag", flush=True)

    # VmRSS around one host-only epoch of the mmap source
    source = make_batch_source(mmap, train_idx, TRAIN_BATCH, BAG)
    before, mapped_before = vm_rss_bytes(), mapped_rss_bytes(csr)
    n = sum(1 for _ in source.batches(np.random.default_rng(0)))
    after, mapped_after = vm_rss_bytes(), mapped_rss_bytes(csr)
    out["mmap_rss"] = {"before": before, "after": after, "mapped_before": mapped_before,
                       "mapped_after": mapped_after, "batches": n}
    print(f"train feed: VmRSS {before / 2**20:.1f} MiB before and {after / 2**20:.1f} MiB after "
          f"an mmap epoch of {n} batches; the container's mapping resident "
          f"{mapped_before / 2**20:.1f} -> {mapped_after / 2**20:.1f} MiB of "
          f"{csr.stat().st_size / 2**20:.1f} MiB", flush=True)

    both = dict(prefetch_batches=2, feed_workers=workers)
    fused = kernel_route("fused")
    runs = [  # (label, data, route, flags, the synchronous run it is held to)
        ("sync", data, "fused", {}, None),
        ("prefetch", data, "fused", dict(prefetch_batches=2), "sync"),
        ("workers", data, "fused", dict(feed_workers=workers), "sync"),
        ("workers+prefetch", data, "fused", both, "sync"),
        ("csr sync", mmap, "fused", {}, None),
        ("csr workers+prefetch", mmap, "fused", both, "csr sync"),
        ("csr bucketed sync", mmap, "fused", dict(bucketed=True), None),
        ("csr bucketed workers+prefetch", mmap, "fused", dict(bucketed=True, **both),
         "csr bucketed sync"),
        ("stream sync", data, "fused", dict(stream_chunk_items=FEED_STREAM_CHUNK), None),
        ("stream prefetch", data, "fused",
         dict(stream_chunk_items=FEED_STREAM_CHUNK, prefetch_batches=2), "stream sync"),
        ("pool_only sync", data, "pool_only", {}, None),
        ("pool_only workers+prefetch", data, "pool_only", both, "pool_only sync"),
    ]
    out["routes"] = {}
    for label, run_data, route, flags, ref in runs:
        kernel = fused if route == "fused" else kernel_route(route)
        run = out["routes"][label] = feed_run(
            torch, smi, dev, run_data, config.with_updates(**kernel, **flags), label, route)
        if ref is not None:
            same_stream(label, run, out["routes"][ref])
    dev_fused = ((device_train or {}).get("routes") or {}).get("fused")
    for label in ("sync", "prefetch", "workers", "workers+prefetch", "csr workers+prefetch",
                  "csr bucketed workers+prefetch", "stream prefetch"):
        run = out["routes"][label]
        print(f"train feed {label} epoch_seconds {[round(m['epoch_seconds'], 4) for m in run['epochs']]}"
              f" vs the train_device phase's fused device epochs (8,192 methods) "
              f"{[round(m['epoch_seconds'], 4) for m in dev_fused['epochs']] if dev_fused else None}"
              f" [{smi}]", flush=True)
    for run in out["routes"].values():
        run.pop("digests")
    return out


# ---------------------------------------------------------------------------
# phase 12: Java source extraction, prediction and serving from source
# ---------------------------------------------------------------------------

EXAMPLES = ROOT / "examples" / "java"
# the share of a method's contexts given to each @var_* alias of the
# train_variable corpus when the extracted examples show less than 10%
VAR_SHARE_FLOOR, VAR_SHARE_FALLBACK = 0.10, 0.15
EXTRACT_TRAIN = dict(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                     max_path_length=BAG, batch_size=8, dropout_prob=0.25, max_epoch=10,
                     random_seed=0, print_sample_cycle=0, use_pallas=True, pallas_impl="fused")
EXTRACT_ROUNDS = 3


def java_variable_share() -> dict:
    """Over the port extractor's records of ``examples/java/src``: for each
    ``@var_*`` alias of each method, the share of the method's contexts
    that touch it (start or end)."""
    from code2vec_tpu_torch.extractor import extract_source

    shares = []
    for path in sorted((EXAMPLES / "src").rglob("*.java")):
        result = extract_source(path.read_text())
        names = result.terminal_vocab
        for m in result.methods:
            for _, alias in m.aliases:
                if alias.startswith("@var_") and m.path_contexts:
                    touching = sum(names[s] == alias or names[e] == alias
                                   for s, _, e in m.path_contexts)
                    shares.append(touching / len(m.path_contexts))
    out = {"aliases": len(shares), "mean": float(np.mean(shares)),
           "median": float(np.median(shares)), "min": float(np.min(shares)),
           "max": float(np.max(shares))}
    out["used"] = out["mean"] if out["mean"] >= VAR_SHARE_FLOOR else VAR_SHARE_FALLBACK
    return out


def top1_agrees(got, want) -> bool:
    """The same top-1 name, unless the plain version's first two are
    within 1e-4 of each other (a tie that rounding may break either way)."""
    p = [x.prob for x in want.predictions]
    return got.predictions[0].name == want.predictions[0].name or (len(p) > 1
                                                                   and p[0] - p[1] < 1e-4)


def percentiles(xs) -> tuple[float, float]:
    return float(np.percentile(xs, 50)), float(np.percentile(xs, 99))


def phase_extract(torch, smi, dev, tmp: Path, built: dict, serve: dict | None) -> dict:
    """Extract ``examples/java`` with the port's extractor (built beside
    the kernels, ``built``), train a method-task and a variable-task model
    on it on the card (fused), predict ``MathUtils.java`` from source
    through K3 against the plain versions on the CPU, and serve the method
    model: every method of the examples as a ``source`` request and as the
    ``contexts`` request of its mapped ids, for predict, embed and
    neighbors, one at a time; the answers must be equal. The extraction
    milliseconds are reported by file, with the files' sizes and the
    methods' contexts, beside the ``serve`` phase's one-at-a-time p50 of
    the top11 model (fused, f32) of this run."""
    import shutil

    from code2vec_tpu_torch import extractor
    from code2vec_tpu_torch.data.reader import load_corpus
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.predict import Predictor
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server
    from code2vec_tpu_torch.train.config import TrainConfig

    out = dict(built)
    print(f"extractor built in {out['build_seconds']:.2f} s "
          f"({'already built' if out['build_cached'] else 'g++, one process a source'}, "
          "beside the kernels' nvcc)", flush=True)
    out["share"] = share = java_variable_share()
    print(f"examples/java: {share['aliases']} @var aliases touch a mean {share['mean']:.4f} "
          f"(median {share['median']:.4f}, {share['min']:.4f}-{share['max']:.4f}) of their "
          f"method's contexts; train_variable gives each alias {share['used']:.4f}", flush=True)
    ds = tmp / "java_dataset"
    ds.mkdir()
    shutil.copy(EXAMPLES / "dataset" / "methods.txt", ds / "methods.txt")
    t0 = time.perf_counter()
    extractor.extract_dataset(ds, EXAMPLES)
    out["extract_dataset_seconds"] = time.perf_counter() - t0
    vocab = (str(ds / "terminal_idxs.txt"), str(ds / "path_idxs.txt"))
    source = (EXAMPLES / "src" / "util" / "MathUtils.java").read_text()
    out["models"] = {}
    for task, (im, iv) in (("method", (True, False)), ("variable", (False, True))):
        data = load_corpus(ds / "corpus.txt", vocab[1], vocab[0], infer_method=im,
                           infer_variable=iv)
        model_dir = tmp / f"java_{task}"
        cfg = TrainConfig(**EXTRACT_TRAIN, infer_method_name=im, infer_variable_name=iv,
                          shuffle_variable_indexes=iv)
        run = train_route(torch, smi, dev, data, cfg, f"extract {task}", ("fused_f32_masked",),
                          str(model_dir), str(model_dir / "code.vec"))
        pred = Predictor(str(model_dir), *vocab, pallas_impl="fused")
        plain = Predictor(str(model_dir), *vocab, device="cpu")
        call = "predict_source" if task == "method" else "predict_variables"
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = getattr(pred, call)(source, top_k=3)
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        want = getattr(plain, call)(source, top_k=3)
        if counts.get("fused_f32", 0) != len(got) or len(got) != len(want) or not got:
            raise AssertionError(f"extract {task}: {len(got)} predictions, {counts}")
        worst = 0.0
        for g, w in zip(got, want):
            if (g.method_name, g.target_variable, g.n_contexts, g.n_oov) != \
                    (w.method_name, w.target_variable, w.n_contexts, w.n_oov) \
                    or not top1_agrees(g, w):
                raise AssertionError(f"extract {task}: {g} vs the plain {w}")
            if not np.allclose(g.code_vector, w.code_vector, rtol=SERVE_RTOL, atol=SERVE_ATOL):
                raise AssertionError(f"extract {task} {g.method_name}: code vector off")
            worst = max(worst, float(np.abs(g.code_vector - w.code_vector).max()))
            print(f"  {call} {g.method_name}: {g.n_contexts} contexts ({g.n_oov} OOV) -> "
                  + ", ".join(f"{p.name} {p.prob:.3f}" for p in g.predictions), flush=True)
        print(f"extract {task}: {call}(MathUtils.java) through K3, {len(got)} predictions "
              f"in {wall_ms:.1f} ms host wall (extraction included), launches {counts}, "
              f"max |cv - plain on the CPU| {worst:.3e} [{smi}]", flush=True)
        out["models"][task] = {"train": run, "predictions": len(got), "wall_ms": wall_ms,
                               "launches": counts, "max_abs_err": worst}

    # the method model served: source requests against contexts requests
    model_dir = tmp / "java_method"
    args = build_parser().parse_args([
        "--model_path", str(model_dir), "--terminal_idx_path", vocab[0],
        "--path_idx_path", vocab[1], "--code_vec_path", str(model_dir / "code.vec")])
    server = build_server(args)
    try:
        pairs, files, method_contexts = [], {}, []
        for path in sorted((EXAMPLES / "src").rglob("*.java")):
            text = path.read_text()
            extracted = server.predictor._extract(text, "*", "java")
            names = [label for label, _, _ in extracted]
            files[path.name] = {"bytes": len(text.encode()), "lines": text.count("\n"),
                                "methods": len(extracted),
                                "contexts": sum(len(c) for _, c, _ in extracted),
                                "extract_ms": []}
            for label, contexts, _ in extracted:
                if names.count(label) != 1:
                    continue
                mapped, _ = server.predictor._map_contexts(contexts)
                method_contexts.append(len(contexts))
                for op in ("predict", "embed", "neighbors"):
                    common = {"op": op, "method_name": label, "top_k": 3, "include_vector": True}
                    pairs.append((path.name, {**common, "source": text},
                                  {**common, "contexts": [list(c) for c in mapped]}))
        lat = {"source": [], "contexts": []}
        extract_ms, worst = [], 0.0
        reset_launch_counts()
        for _ in range(EXTRACT_ROUNDS):
            for name, by_source, by_contexts in pairs:
                t0 = time.perf_counter()
                a = server.handle(by_source)
                t1 = time.perf_counter()
                b = server.handle(by_contexts)
                t2 = time.perf_counter()
                lat["source"].append((t1 - t0) * 1e3)
                lat["contexts"].append((t2 - t1) * 1e3)
                if not (a.get("ok") and b.get("ok")):
                    raise AssertionError(f"serve from source: {a} / {b}")
                extract_ms.append(a["extract_ms"])
                files[name]["extract_ms"].append(a["extract_ms"])
                (ea,), (eb,) = a["methods"], b["methods"]
                for key in ("method_name", "n_contexts", "predictions", "neighbors"):
                    if ea.get(key) != eb.get(key):
                        raise AssertionError(f"serve {by_source['op']} {ea['method_name']}: "
                                             f"{key} {ea.get(key)} vs {eb.get(key)}")
                va, vb = np.asarray(ea["code_vector"]), np.asarray(eb["code_vector"])
                if not np.isfinite(va).all() or not np.allclose(va, vb, rtol=0, atol=1e-6):
                    raise AssertionError(f"serve {ea['method_name']}: code vectors differ")
                worst = max(worst, float(np.abs(va - vb).max()))
        counts = launch_counts()
        if counts.get("fused_f32", 0) < len(pairs):
            raise AssertionError(f"serve from source never went through K3: {counts}")
        health = server.handle({"op": "health"})
    finally:
        server.close()
    out["serve"] = {"requests_per_form": len(pairs) * EXTRACT_ROUNDS, "launches": counts,
                    "max_abs_diff": worst, "post_warmup_compiles":
                    health["post_warmup_compiles"], "warmup_extractor_ms":
                    health["extractor_ms"]}
    for name, f in files.items():
        f["extract_p50_ms"] = float(np.percentile(f.pop("extract_ms"), 50))
        print(f"  {name}: {f['bytes']} bytes, {f['lines']} lines, {f['methods']} methods, "
              f"{f['contexts']} contexts; extraction p50 {f['extract_p50_ms']:.3f} ms a request",
              flush=True)
    out["files"] = files
    mc = np.asarray(method_contexts)
    out["method_contexts"] = {"methods": len(mc), "mean": float(mc.mean()),
                              "median": float(np.median(mc)), "max": int(mc.max())}
    for form, xs in lat.items():
        out["serve"][f"{form}_p50_ms"], out["serve"][f"{form}_p99_ms"] = percentiles(xs)
    out["serve"]["extract_p50_ms"], out["serve"]["extract_p99_ms"] = percentiles(extract_ms)
    sv = out["serve"]
    print(f"serve from source: {sv['requests_per_form']} requests a form (predict, embed, "
          f"neighbors; {len(pairs) // 3} methods x {EXTRACT_ROUNDS} rounds, one at a time): "
          f"source p50 {sv['source_p50_ms']:.3f} / p99 {sv['source_p99_ms']:.3f} ms, of it the "
          f"extraction p50 {sv['extract_p50_ms']:.3f} / p99 {sv['extract_p99_ms']:.3f} ms (host); "
          f"contexts p50 {sv['contexts_p50_ms']:.3f} / p99 {sv['contexts_p99_ms']:.3f} ms; "
          f"answers equal (max |cv diff| {worst:.1e}), launches {counts}, post-warmup compiles "
          f"{sv['post_warmup_compiles']}, the extractor loaded in the warmup in "
          f"{sv['warmup_extractor_ms']:.3f} ms [{smi}]", flush=True)
    top11 = (serve or {}).get("fused_f32", {}).get("sequential_p50_ms")
    sv["top11_fused_f32_p50_ms"] = top11
    print(f"the served methods hold {mc.mean():.1f} contexts on average (median "
          f"{np.median(mc):.0f}, max {mc.max()}) in files of "
          f"{min(f['bytes'] for f in files.values())}-{max(f['bytes'] for f in files.values())} "
          f"bytes; extraction p50 {sv['extract_p50_ms']:.3f} ms against the top11 model's "
          f"one-at-a-time p50 (serve phase, fused f32) "
          + (f"{top11:.3f} ms" if top11 is not None else "not measured") + f" [{smi}]",
          flush=True)
    if sv["post_warmup_compiles"]:
        raise AssertionError("the server warmed a shape after startup")
    return out


# ---------------------------------------------------------------------------
# phase 13: the variable-name task (--infer_variable_name, --shuffle_variable_indexes)
# ---------------------------------------------------------------------------

VAR_NAMES = 2_000


def variable_corpus(share: float, infer_method: bool = False):
    """The train phase's corpus with 0-3 ``@var_*`` aliases a method (as
    ``data/synth.generate_corpus_files`` draws them), each alias put at the
    start or the end of ``share`` of its method's contexts (at least one),
    named from a pool of camelCase variable names that follows the method's
    label, so the names can be learned from the contexts."""
    from dataclasses import replace

    from code2vec_tpu_torch.data.reader import _build_label_state
    from code2vec_tpu_torch.data.synth import _label_names

    raw, base = train_corpus()
    rng = np.random.default_rng(7)
    names = _label_names(VAR_NAMES, rng)
    stoi = base.terminal_vocab.stoi
    counts = np.diff(base.row_splits)
    n_aliases = rng.integers(0, 4, base.n_items)
    starts, ends = base.starts.copy(), base.ends.copy()
    var_lists = []
    for i in range(base.n_items):
        lo, n = int(base.row_splits[i]), int(counts[i])
        pairs = []
        for j in range(int(n_aliases[i])):
            slots = lo + rng.choice(n, max(1, round(share * n)), replace=False)
            at_end = rng.random(len(slots)) < 0.5
            starts[slots[~at_end]] = stoi[f"@var_{j}"]
            ends[slots[at_end]] = stoi[f"@var_{j}"]
            pairs.append((names[(int(raw.label_ids[i]) * 3 + j) % VAR_NAMES], f"@var_{j}"))
        var_lists.append(pairs)
    headers = [(raw.label_names[int(k)], None) for k in raw.label_ids]
    label_vocab, labels, normalized, sources, aliases = _build_label_state(
        headers, var_lists, infer_method, True)
    return replace(base, starts=starts, ends=ends, labels=np.asarray(labels, np.int32),
                   normalized_labels=normalized, sources=sources, aliases=aliases,
                   label_vocab=label_vocab, infer_method=infer_method, infer_variable=True,
                   variable_indexes=np.asarray(sorted(i for k, i in stoi.items()
                                                      if k.startswith("@var_")), np.int32))


def variable_batch(data, config):
    """A variable-task batch of 1024 rows at bag 200: row 0 an alias no
    context touches (all PAD, still an example), rows 1-255 one context."""
    from code2vec_tpu_torch.data.pipeline import build_variable_epoch, iter_batches

    rng = np.random.default_rng(11)
    items = rng.permutation(data.n_items)[:TRAIN_BATCH]
    epoch = build_variable_epoch(data, items, config.max_path_length, rng, True)
    batch = next(iter_batches(epoch, TRAIN_BATCH))
    for k in ("starts", "paths", "ends"):
        batch[k] = batch[k].copy()
        batch[k][0] = 0
        batch[k][1:256, 1:] = 0
    return batch


def phase_train_variable(torch, smi, dev, share) -> dict:
    """The variable-name task at the train phase's widths, batch, bag and
    dropout (variable-only, --shuffle_variable_indexes): host-fed and
    --device_epoch, each at a fixed bag and --bucketed, on every route; the
    dual task (method and variable rows) on fused, host-fed and on the
    device; fused device epochs lazy in bf16. Each kernel launched once for
    every batch of the passes that run it, each run's train loss lower
    after the last epoch than after the first; the step breakdown of variable
    batches (plain, fused); a differential on a batch with an
    all-PAD row and 1-context rows; per route a device chunk against the
    host step and a warm chunk, the remap on, under the sync debug mode."""
    from code2vec_tpu_torch.data.pipeline import bucket_batch_counts, split_items
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import resolve_ladder, stage_host

    if share is None:
        share = java_variable_share()
    t0 = time.perf_counter()
    data = variable_corpus(share["used"])
    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=BAG, batch_size=TRAIN_BATCH, dropout_prob=0.25,
                         max_epoch=2, random_seed=0, print_sample_cycle=0,
                         infer_method_name=False, infer_variable_name=True,
                         shuffle_variable_indexes=True)
    ladder, _ = resolve_ladder(config.with_updates(bucketed=True), data)
    out = {"share": share["used"], "ladder": list(ladder), "routes": {}}

    def geometry(d):
        """Each split's rows' context counts, and their batches an epoch
        per ladder width (fixed: one width)."""
        train_idx, test_idx = split_items(d.n_items, np.random.default_rng(config.random_seed))
        counts = [stage_host(d, idx, np.random.default_rng(0)).counts
                  for idx in (train_idx, test_idx)]
        return counts, {layout: [bucket_batch_counts(c, lad, TRAIN_BATCH) for c in counts]
                        for layout, lad in (("fixed", (BAG,)), ("bucketed", ladder))}

    counts, batches = geometry(data)
    real = np.minimum(counts[0], BAG)
    out["rows"] = {"train": len(counts[0]), "test": len(counts[1]),
                   "mean_real_contexts": float(real.mean()), "empty": int((real == 0).sum())}
    print(f"variable corpus: {data.n_items} methods, {len(data.variable_indexes)} @var ids, "
          f"{len(data.label_vocab)} labels, share {share['used']:.4f}; {len(counts[0])} train / "
          f"{len(counts[1])} test variable rows, mean {real.mean():.2f} real contexts a train "
          f"row (bag {BAG}), {out['rows']['empty']} empty; bucketed ladder {list(ladder)}, made "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    dual = variable_corpus(share["used"], infer_method=True)
    _, dual_batches = geometry(dual)
    lazy_bf16 = dict(table_update="lazy", compute_dtype="bfloat16", adam_mu_dtype="bfloat16")
    runs = [(f"{feed} {layout} {route}", route, data, batches[layout],
             dict(device_epoch=feed == "device", bucketed=layout == "bucketed"))
            for feed in ("host", "device") for layout in ("fixed", "bucketed")
            for route in DEVICE_ROUTES]
    runs += [("dual host fixed fused", "fused", dual, dual_batches["fixed"],
              dict(infer_method_name=True)),
             ("dual device fixed fused", "fused", dual, dual_batches["fixed"],
              dict(infer_method_name=True, device_epoch=True)),
             ("device fixed fused lazy bf16", "fused", data, batches["fixed"],
              dict(device_epoch=True, **lazy_bf16))]
    for label, route, d, (n_train, n_test), kw in runs:
        keys = DEVICE_ROUTES[route]
        run = out["routes"][label] = train_route(
            torch, smi, dev, d, config.with_updates(**kernel_route(route), **kw),
            f"variable {label}", tuple(keys))
        device_launches(f"variable {label}", run, keys, n_train, n_test, config.max_epoch)
        losses = [m["train_loss"] for m in run["epochs"]]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"variable {label}: train losses {losses}")
        if kw.get("device_epoch") and not kw.get("table_update"):
            host = out["routes"].get(label.replace("device", "host"))
            beside_host(f"variable {label.replace('device ', '')}", run, host, smi)
    out["breakdown"] = step_breakdown(torch, dev, data, config, smi, "variable ",
                                      ("plain", "fused"))
    out["differential"] = train_differential(
        torch, dev, data, config, [variable_batch(data, config)],
        {route: kernel_route(route) for route in TRAIN_ROUTES})
    out["chunks"] = {route: device_chunk_checks(torch, dev, data, config, route, smi,
                                                f"variable {route}")
                     for route in DEVICE_ROUTES}
    return out


# ---------------------------------------------------------------------------
# phase 14: Python sources, a mixed Java + Python corpus, whole-file vectors
# ---------------------------------------------------------------------------

PY_EXAMPLES = ROOT / "examples" / "python"
# the JAX package's own sources, read as text and never imported: the package
# is frozen, so this corpus of real Python is fixed
PY_PACKAGE = ROOT / "code2vec_tpu"
PY_TRAIN = dict(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                max_path_length=BAG, batch_size=64, dropout_prob=0.25, max_epoch=5,
                random_seed=0, print_sample_cycle=0)
PY_ROUTES = ("fused", "pool_only")
PY_TOP_K = 5


def python_corpus_rows() -> list[tuple[str, str]]:
    """``methods.txt`` rows, relative to the repo root: the Java and the
    Python examples' own rows, then one ``<file>\t*`` row for each
    ``code2vec_tpu/**/*.py``."""
    from code2vec_tpu_torch.extractor import read_method_rows

    rows = []
    for example in (EXAMPLES, PY_EXAMPLES):
        prefix = example.relative_to(ROOT).as_posix()
        rows += [(f"{prefix}/{src}", name) for src, name in read_method_rows(example / "dataset")]
    return rows + [(p.relative_to(ROOT).as_posix(), "*") for p in sorted(PY_PACKAGE.rglob("*.py"))]


def size_table(files: dict, key: str) -> dict:
    """``key`` (ms a file) by file size: count, p50 and max under 10 KB,
    10-90 KB and above."""
    out = {}
    for name, lo, hi in (("<10KB", 0, 10_000), ("10-90KB", 10_000, 90_000),
                         (">90KB", 90_000, math.inf)):
        xs = [f[key] for f in files.values() if lo <= f["bytes"] < hi and f.get(key) is not None]
        out[name] = ({"files": len(xs), "p50_ms": float(np.percentile(xs, 50)),
                      "max_ms": float(np.max(xs))} if xs else {"files": 0})
    return out


def phase_python_source(torch, smi, dev, tmp: Path, serve: dict | None) -> dict:
    """(a) the mixed Java + Python corpus extracted by the port's CLI (the
    examples' rows and every file of the JAX package); (b) a method model at
    top11's widths trained on it on fused (masked K3) and pool_only (K1 +
    K1b), each kernel once a batch; (c) ``math_utils.py`` predicted and
    embedded as a file through K3 against the plain versions on the CPU;
    (d) every Python function served one at a time as a ``source`` request
    (predict and embed; K3, and K4 at the long-bag rungs) and every Python
    file as ``embed_file``, the embeddings against the model run plain on
    the card; (e) ``code.vec`` of those embeddings, ``file.vec`` from
    ``export_file_vectors``, its index from the port's ``ann_build``, and
    every file's ``neighbors`` at ``granularity="file"`` on the exact
    backend (itself first, similarity within 1e-4 of 1) and on IVF-PQ
    (itself in the top k, K5 launched)."""
    from code2vec_tpu_torch import extractor
    from code2vec_tpu_torch.data.pipeline import nearest_bucket_width, truncated_fraction_of_counts
    from code2vec_tpu_torch.data.reader import load_corpus
    from code2vec_tpu_torch.export import export_file_vectors
    from code2vec_tpu_torch.formats.params_io import read_params
    from code2vec_tpu_torch.formats.vectors_io import (
        append_code_vectors,
        read_code_vectors,
        write_code_vectors_header,
    )
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.models.hierarchical import pool_vectors
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.predict import Predictor, subsample
    from code2vec_tpu_torch.pyextract import extract_python_source
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server
    from code2vec_tpu_torch.tools import ann_build
    from code2vec_tpu_torch.train.config import TrainConfig

    out = {}
    # (a) extract
    rows = python_corpus_rows()
    ds = tmp / "py_dataset"
    ds.mkdir()
    (ds / "methods.txt").write_text("".join(f"{src}\t{name}\n" for src, name in rows))
    t0 = time.perf_counter()
    if extractor.main([str(ds), str(ROOT)]) != 0:
        raise AssertionError("the mixed extraction failed")
    extract_seconds = time.perf_counter() - t0
    params = read_params(ds / "params.txt")
    data = load_corpus(ds / "corpus.txt", ds / "path_idxs.txt", ds / "terminal_idxs.txt")
    counts = np.diff(data.row_splits)
    actual = [line.split("\t") for line in (ds / "actual_methods.txt").read_text().splitlines()]
    by_file: dict[str, list[str]] = {}
    for src, label, _, _ in actual:
        by_file.setdefault(src, []).append(label)
    py_files = sorted(f for f in {src for src, _ in rows} if f.endswith(".py"))
    geo = out["geometry"] = {
        "rows": len(rows), "files": len({src for src, _ in rows}), "python_files": len(py_files),
        "functions": data.n_items,
        "java_methods": sum(src.endswith(".java") for src, *_ in actual),
        "python_functions": sum(src.endswith(".py") for src, *_ in actual),
        "labels": len(data.label_vocab),
        "method_name_vocab_count": int(params["method_name_vocab_count"]),
        "terminals": int(params["terminal_vocab_count"]),
        "paths": int(params["path_vocab_count"]), "contexts": int(counts.sum()),
        "mean_contexts": float(counts.mean()), "max_contexts": int(counts.max()),
        "share_over_200": float((counts > BAG).mean()),
        "share_over_2048": float((counts > LONGBAG_RUNGS[-1]).mean()),
        "truncated_context_fraction": truncated_fraction_of_counts(counts, BAG),
        "extract_seconds": extract_seconds,
    }
    files = {}
    for rel in py_files:
        text = (ROOT / rel).read_text()
        t0 = time.perf_counter()
        methods = extract_python_source(text)
        files[rel] = {"bytes": len(text.encode()), "functions": len(methods),
                      "contexts": sum(len(m.contexts) for m in methods),
                      "extract_ms": (time.perf_counter() - t0) * 1e3}
    out["extract_by_size"] = size_table(files, "extract_ms")
    print(f"python_source corpus: {geo['rows']} rows ({geo['python_files']} Python files), "
          f"{geo['functions']} methods ({geo['java_methods']} Java + {geo['python_functions']} "
          f"Python), {geo['labels']} labels ({geo['method_name_vocab_count']} distinct names), "
          f"{geo['terminals']} terminals, {geo['paths']} paths, {geo['contexts']} contexts (mean "
          f"{geo['mean_contexts']:.1f}, max {geo['max_contexts']}; {geo['share_over_200']:.4f} "
          f"over {BAG}, {geo['share_over_2048']:.4f} over {LONGBAG_RUNGS[-1]}), "
          f"truncated_context_fraction {geo['truncated_context_fraction']:.4f} at bag {BAG}; "
          f"extracted in {extract_seconds:.2f} s (host)", flush=True)
    print("python_source extraction ms by file, (bytes, ms) from the smallest: "
          + " ".join(f"({f['bytes']}, {f['extract_ms']:.1f})"
                     for f in sorted(files.values(), key=lambda f: f["bytes"])), flush=True)
    biggest = max(files, key=lambda f: files[f]["bytes"])
    print(f"python_source extraction a file (extract_python_source, host): "
          f"{json.dumps(out['extract_by_size'])}; the largest, {biggest} "
          f"({files[biggest]['bytes']} bytes), {files[biggest]['extract_ms']:.1f} ms", flush=True)

    # (b) train at top11's widths on fused and pool_only
    config = TrainConfig(**PY_TRAIN)
    n_train, n_test = split_batches(data, config, (BAG,), BAG)
    model_dir = tmp / "py_model"
    out["train"] = {}
    for route in PY_ROUTES:
        keys = DEVICE_ROUTES[route]
        run = train_route(torch, smi, dev, data, config.with_updates(**kernel_route(route)),
                          f"python {route}", tuple(keys),
                          str(model_dir) if route == "fused" else None)
        device_launches(f"python {route}", run, keys, n_train, n_test, config.max_epoch)
        out["train"][route] = run
        print(f"train python {route}: every kernel of {sorted(keys)} once a batch "
              f"({int(n_train.sum())} train / {int(n_test.sum())} test batches an epoch, "
              f"{config.max_epoch} epochs)", flush=True)
    vocab = (str(ds / "terminal_idxs.txt"), str(ds / "path_idxs.txt"))

    # (c) predict math_utils.py through K3 against the plain versions on the CPU
    source = (PY_EXAMPLES / "src" / "util" / "math_utils.py").read_text()
    pred = Predictor(str(model_dir), *vocab, pallas_impl="fused")
    plain = Predictor(str(model_dir), *vocab, device="cpu")
    reset_launch_counts()
    t0 = time.perf_counter()
    got = pred.predict_source(source, language="python", top_k=3)
    wall_ms = (time.perf_counter() - t0) * 1e3
    vec, names = pred.embed_file(source, language="python")
    counts_c = launch_counts()
    want = plain.predict_source(source, language="python", top_k=3)
    want_vec, want_names = plain.embed_file(source, language="python")
    if not got or len(got) != len(want) or \
            counts_c.get("fused_f32", 0) != len(got) + len(names):
        raise AssertionError(f"python predict: {len(got)} predictions, {counts_c}")
    worst = 0.0
    for g, w in zip(got, want):
        if (g.method_name, g.n_contexts, g.n_oov) != (w.method_name, w.n_contexts, w.n_oov) \
                or not top1_agrees(g, w):
            raise AssertionError(f"python predict: {g} vs the plain {w}")
        if not (np.allclose(g.code_vector, w.code_vector, rtol=SERVE_RTOL, atol=SERVE_ATOL)
                and np.allclose([p.prob for p in g.predictions], [p.prob for p in w.predictions],
                                rtol=SERVE_RTOL, atol=SERVE_ATOL)):
            raise AssertionError(f"python predict {g.method_name}: off the plain version")
        worst = max(worst, float(np.abs(g.code_vector - w.code_vector).max()))
    if names != want_names or not np.allclose(vec, want_vec, rtol=SERVE_RTOL, atol=SERVE_ATOL):
        raise AssertionError("python embed_file: off the plain version")
    worst = max(worst, float(np.abs(vec - want_vec).max()))
    out["predict"] = {"predictions": len(got), "wall_ms": wall_ms, "launches": counts_c,
                      "max_abs_err": worst}
    print(f"python predict_source(math_utils.py) through K3: {len(got)} functions in "
          f"{wall_ms:.1f} ms host wall (extraction included), embed_file pooled {len(names)}; "
          f"launches {counts_c}; max |cv - plain on the CPU| {worst:.3e} [{smi}]", flush=True)
    for g in got:
        print(f"  {g.method_name}: {g.n_contexts} contexts -> "
              + ", ".join(f"{p.name} {p.prob:.3f}" for p in g.predictions), flush=True)

    # (d) serve every Python function and file, one request at a time
    common = ["--model_path", str(model_dir), "--terminal_idx_path", vocab[0],
              "--path_idx_path", vocab[1], "--longbag_widths",
              ",".join(map(str, LONGBAG_RUNGS))]
    server = build_server(build_parser().parse_args(common))
    texts = {rel: (ROOT / rel).read_text() for rel in py_files}
    lat = {"predict": [], "embed": [], "embed_file": []}
    method_vectors, method_files, method_names = [], [], []
    served = []  # (file, name, entries) of the embed requests
    try:
        reset_launch_counts()
        for rel in py_files:
            ms_file = []
            for name in dict.fromkeys(by_file.get(rel, [])):
                for op in ("predict", "embed"):
                    t0 = time.perf_counter()
                    resp = server.handle({"op": op, "source": texts[rel], "language": "python",
                                          "method_name": name, "top_k": 3})
                    lat[op].append((time.perf_counter() - t0) * 1e3)
                    if not resp.get("ok") or not resp["methods"] or \
                            any("error" in e for e in resp["methods"]):
                        raise AssertionError(f"serve {op} {rel}:{name}: {resp}")
                    ms_file.append(resp["extract_ms"])
                    if op == "embed":
                        served.append((rel, name, resp["methods"]))
            t0 = time.perf_counter()
            resp = server.handle({"op": "embed_file", "source": texts[rel], "language": "python"})
            ms = (time.perf_counter() - t0) * 1e3
            n_methods = len(by_file.get(rel, []))
            if n_methods == 0:
                if resp.get("error_kind") != "bad_request":
                    raise AssertionError(f"embed_file {rel} (no function): {resp}")
                continue
            if not resp.get("ok") or resp["n_methods"] != n_methods:
                raise AssertionError(f"embed_file {rel}: {n_methods} functions, {resp}")
            lat["embed_file"].append(ms)
            files[rel].update(embed_file_ms=ms, embed_file_extract_ms=resp["extract_ms"],
                              file_vector=resp["file_vector"],
                              request_extract_p50_ms=float(np.percentile(ms_file, 50)))
        counts_d = launch_counts()
        health = server.handle({"op": "health"})
    finally:
        server.close()
    # the served embeddings against the model run plain on the card (f32, no kernel)
    predictor = server.predictor
    with torch.device("meta"):
        plain_model = Code2Vec(predictor.config.with_updates(use_pallas=False))
    plain_model.load_state_dict(predictor.model.state_dict(), assign=True)
    plain_model.eval()
    mapped_by_file = {}
    worst, n_long, long_requests, widths = 0.0, 0, 0, []
    for rel, name, entries in served:
        if rel not in mapped_by_file:
            mapped_by_file[rel] = [(label, predictor._map_contexts(ctx)[0]) for label, ctx, _ in
                                   predictor._extract(texts[rel], "*", "python")]
        mine = [m for label, m in mapped_by_file[rel] if label == name]
        if len(mine) != len(entries):
            raise AssertionError(f"serve {rel}:{name}: {len(entries)} entries, {len(mine)} methods")
        long_requests += any(e["timing"]["width"] > BAG for e in entries)
        for entry, mapped in zip(entries, mine):
            ctx = np.asarray(subsample(mapped, predictor.bag), np.int32)
            width = nearest_bucket_width(len(ctx), predictor.ladder)
            ids = np.zeros((3, 1, width), np.int32)
            ids[:, 0, :len(ctx)] = ctx.T
            with torch.inference_mode():
                _, ref, _ = plain_model(*(torch.from_numpy(x).to(dev) for x in ids))
            cv = np.asarray(entry["code_vector"], np.float32)
            ref = ref[0].cpu().numpy()
            if entry["n_contexts"] != len(ctx) or not np.isfinite(cv).all() or \
                    not np.allclose(cv, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL):
                raise AssertionError(f"serve embed {rel}:{name}: off the plain version")
            worst = max(worst, float(np.abs(cv - ref).max()))
            widths.append(entry["timing"]["width"])
            n_long += entry["timing"]["width"] > BAG
            method_vectors.append(cv)
            method_files.append(rel)
            method_names.append(name)
    k3, k4 = counts_d.get("fused_f32", 0), counts_d.get("online_f32", 0)
    if not (n_long and k4 >= long_requests and k3 >= 1) or health["post_warmup_compiles"]:
        raise AssertionError(f"python serve: {n_long} long-bag methods in {long_requests} "
                             f"requests, launches {counts_d}, health {health}")
    sv = out["serve"] = {"requests": {op: len(x) for op, x in lat.items()},
                         "launches": counts_d, "long_bag_methods": n_long,
                         "long_bag_requests": long_requests, "max_abs_err": worst,
                         "widths": {int(w): int(n) for w, n in
                                    zip(*np.unique(widths, return_counts=True))}}
    for op, xs in lat.items():
        sv[f"{op}_p50_ms"], sv[f"{op}_p99_ms"] = percentiles(xs)
    sv["embed_file_by_size"] = size_table(files, "embed_file_ms")
    sv["embed_file_extract_by_size"] = size_table(files, "embed_file_extract_ms")
    share = [f["embed_file_extract_ms"] / f["embed_file_ms"] for f in files.values()
             if f.get("embed_file_ms") and 10_000 <= f["bytes"] < 90_000]
    sv["extract_share_10_90KB"] = (float(np.median(share)), float(np.min(share)),
                                   float(np.max(share))) if share else None
    top11 = (serve or {}).get("fused_f32", {}).get("sequential_p50_ms")
    sv["top11_fused_f32_p50_ms"] = top11
    print(f"python serve, one at a time: predict p50 {sv['predict_p50_ms']:.3f} / p99 "
          f"{sv['predict_p99_ms']:.3f} ms, embed {sv['embed_p50_ms']:.3f} / "
          f"{sv['embed_p99_ms']:.3f} ms ({sv['requests']['embed']} functions each), embed_file "
          f"{sv['embed_file_p50_ms']:.3f} / {sv['embed_file_p99_ms']:.3f} ms "
          f"({sv['requests']['embed_file']} files); widths served {sv['widths']}, {n_long} "
          f"long-bag methods in {long_requests} requests; launches {counts_d}; max |cv - plain| "
          f"{worst:.3e}; the top11 one-at-a-time p50 (serve phase) "
          + (f"{top11:.3f} ms" if top11 is not None else "not measured") + f" [{smi}]",
          flush=True)
    print(f"python embed_file by file size: {json.dumps(sv['embed_file_by_size'])}; its "
          f"extract_ms: {json.dumps(sv['embed_file_extract_by_size'])}; extract_ms / request "
          f"ms for 10-90 KB files (median, min, max): {sv['extract_share_10_90KB']} [{smi}]",
          flush=True)

    # (e) code.vec -> file.vec -> ann_build -> file neighbors
    code_vec, file_vec, index = tmp / "py_code.vec", tmp / "py_file.vec", tmp / "py_ann.index"
    write_code_vectors_header(code_vec, len(method_vectors), predictor.config.encode_size)
    append_code_vectors(code_vec, method_names, np.stack(method_vectors))
    labels, rows_read = read_code_vectors(code_vec)
    if labels != method_names:
        raise AssertionError("code.vec did not read back")
    attn = predictor.attention_vector()
    keys, pooled = export_file_vectors(rows_read, method_files, str(file_vec), attn_param=attn)
    for key, vec in zip(keys, pooled):
        served_vec = np.asarray(files[key]["file_vector"], np.float32)
        if not np.allclose(served_vec, vec, rtol=SERVE_RTOL, atol=SERVE_ATOL):
            raise AssertionError(f"embed_file {key}: the served vector is not the export's")
    for key in keys:
        files[key].pop("file_vector")
    t0 = time.perf_counter()
    if ann_build.main(["--code_vec", str(file_vec), "--out", str(index)]) != 0:
        raise AssertionError("ann_build failed")
    build_s = time.perf_counter() - t0
    search = out["search"] = {"files": len(keys), "ann_build_seconds": build_s}
    for backend, extra in (("exact", ["--code_vec_path", str(file_vec)]),
                           ("ann", ["--retrieval_backend", "ann", "--ann_index_path",
                                    str(index)])):
        server = build_server(build_parser().parse_args(common + extra))
        xs, sims, ranks = [], [], []
        try:
            reset_launch_counts()
            for key in keys:
                t0 = time.perf_counter()
                resp = server.handle({"op": "neighbors", "source": texts[key],
                                      "language": "python", "granularity": "file",
                                      "top_k": PY_TOP_K})
                xs.append((time.perf_counter() - t0) * 1e3)
                names_k = [n["name"] for n in resp.get("neighbors", [])]
                if not resp.get("ok") or key not in names_k:
                    raise AssertionError(f"neighbors {backend} {key}: {resp}")
                ranks.append(names_k.index(key))
                sims.append(resp["neighbors"][ranks[-1]]["similarity"])
            counts_e = launch_counts()
            describe = server.retrieval.describe()
        finally:
            server.close()
        if backend == "exact" and (any(ranks) or max(abs(s - 1.0) for s in sims) > 1e-4):
            raise AssertionError(f"exact file neighbors: ranks {ranks}, similarities {sims}")
        if backend == "ann" and counts_e.get("lut_score", 0) < len(keys):
            raise AssertionError(f"ann file neighbors launched K5 {counts_e} for {len(keys)}")
        p50, p99 = percentiles(xs)
        search[backend] = {"p50_ms": p50, "p99_ms": p99, "launches": counts_e,
                           "rank_counts": {int(r): int(n) for r, n in
                                           zip(*np.unique(ranks, return_counts=True))},
                           "max_abs_sim_minus_1": float(max(abs(s - 1.0) for s in sims)),
                           "index": {k: describe.get(k) for k in ("n_list", "n_probe",
                                                                   "shortlist", "size")}}
        print(f"python file neighbors, {backend}: {len(keys)} files one at a time, p50 {p50:.3f} "
              f"/ p99 {p99:.3f} ms, own file at ranks {search[backend]['rank_counts']}, max "
              f"|similarity - 1| {search[backend]['max_abs_sim_minus_1']:.2e}, launches "
              f"{counts_e} [{smi}]", flush=True)
    out["files"] = files
    out["ann_build_seconds"] = build_s
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json_out", default=None,
                        help="also write the per-shape kernel records and serve numbers here")
    parser.add_argument("--phases", default=None,
                        help="run only these phases (comma list) after device and build, and "
                             "print no result line: for working on one phase")
    parser.add_argument("--mesh_worker", nargs=2, metavar=("SPEC", "RANK"), default=None,
                        help=argparse.SUPPRESS)  # one rank of the train_mesh phase's pair
    args = parser.parse_args()
    if args.mesh_worker is not None:
        return mesh_worker(args.mesh_worker[0], int(args.mesh_worker[1]))
    only = set(args.phases.split(",")) if args.phases else None
    started = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    failed = []

    def phase(name, fn, *a):
        if only is not None and name not in only | {"device", "build"}:
            return None
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            return fn(*a)
        except Exception:  # noqa: BLE001 - every phase reports, the run fails
            traceback.print_exc()
            failed.append(name)
            return None
        finally:
            print(f"== phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)

    def device():
        cap = torch.cuda.get_device_capability(0)
        if cap != (9, 0):
            raise RuntimeError(f"needs compute capability 9.0 (Hopper), got {cap}")
        smi = nvidia_smi()
        print(smi)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return smi

    extractor_build = {}

    def build():
        """The kernels (one nvcc a source) and, beside them in a thread,
        the Java extractor (one g++ a source), all started together."""
        sys.path.insert(0, str(ROOT))
        from concurrent.futures import ThreadPoolExecutor

        from code2vec_tpu_torch import extractor
        from code2vec_tpu_torch.ops import _build

        def build_extractor():
            cached = (extractor.build_dir() / extractor.LIBRARY).exists()
            t0 = time.perf_counter()
            extractor.build_extractor()
            return {"build_seconds": time.perf_counter() - t0, "build_cached": cached}

        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            ext = pool.submit(build_extractor)
            libs = _build.build_all()
            extractor_build.update(ext.result())
        print(f"built {sorted(libs)} and the Java extractor in {time.perf_counter() - t0:.1f}s "
              f"(the extractor {extractor_build['build_seconds']:.2f} s of it"
              f"{', already built' if extractor_build['build_cached'] else ''})", flush=True)
        for name, log in sorted(_build.build_log.items()):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        sass_check(_build, libs["fused_encode_pool"])
        return libs

    smi = phase("device", device)
    if smi is None or phase("build", build) is None:
        return 1
    dev = torch.device("cuda")
    kernels, floor = phase("kernels", phase_kernels, torch, dev, smi) or (None, None)
    with tempfile.TemporaryDirectory(prefix="c2v_smoke_") as tmp:
        model_dir = Path(tmp)
        t0 = time.perf_counter()
        write_model_dir(torch, model_dir, dev)
        print(f"model dir at top11 widths written in {time.perf_counter() - t0:.1f}s", flush=True)
        serve = phase("serve", phase_serve, torch, smi, dev, model_dir)
        longbag = phase("longbag", phase_longbag, torch, smi, dev, model_dir)
        retrieval = phase("retrieval", phase_retrieval, torch, smi, dev, model_dir)
        control = phase("serve_control", phase_serve_control, torch, smi, dev, model_dir / "ctl",
                        model_dir)
        trained = phase("train", phase_train, torch, smi, dev, model_dir)
        elastic = phase("train_elastic", phase_train_elastic, torch, smi, dev, model_dir)
        searched = phase("train_hpo", phase_train_hpo, torch, smi, dev, model_dir, elastic)
        meshed = phase("train_mesh", phase_train_mesh, torch, smi, dev, model_dir, elastic)
        tuned = phase("autotune", phase_autotune, torch, smi, dev, model_dir, model_dir,
                      elastic)
        bucketed = phase("train_bucketed", phase_train_bucketed, torch, smi, dev, model_dir)
        bf16_train = phase("train_bf16", phase_train_bf16, torch, smi, dev, model_dir, trained)
        lazy_train = phase("train_lazy", phase_train_lazy, torch, smi, dev, trained, bucketed,
                           bf16_train)
        device_train = phase("train_device", phase_train_device, torch, smi, dev, trained,
                             bucketed, lazy_train)
        feed_train = phase("train_feed", phase_train_feed, torch, smi, dev, model_dir,
                           device_train)
        extracted = phase("extract", phase_extract, torch, smi, dev, model_dir,
                          extractor_build, serve)
        python = phase("python_source", phase_python_source, torch, smi, dev, model_dir,
                       serve)
        variable = phase("train_variable", phase_train_variable, torch, smi, dev,
                         (extracted or {}).get("share"))
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if only is not None:
        print(f"chip_smoke: ran {sorted(only)} only; no result line", file=sys.stderr)
        return 0

    routes = {**serve, **longbag}
    for route, keys in TRAIN_ROUTES.items():  # K1b and the masked K2/K3 train
        for key in keys:
            routes.setdefault(key, trained["routes"][route])
    for route, (_, keys) in LONGBAG_ROUTES.items():  # the masked K4 trains long bags
        for key in keys:
            routes.setdefault(key, bucketed["longbag"]["routes"][route])
    for route in ("pool_only", "gather_split"):  # the bf16 kernels train (and eval) in bf16
        for key in bf16_train["routes"][route]["launches"]:
            routes.setdefault(key, bf16_train["routes"][route])
    # the device-epoch runs of the train phase's routes launch the same kernels
    device_counts = {}
    for route in DEVICE_ROUTES:
        for key, n in device_train["routes"][route]["launches"].items():
            device_counts[key] = device_counts.get(key, 0) + n
    # the train_variable phase's runs launch the same kernels on variable rows
    var_counts = {}
    for run in variable["routes"].values():
        for key, n in run["launches"].items():
            var_counts[key] = var_counts.get(key, 0) + n
    print(f"train_variable launches: {json.dumps(var_counts)}")
    # the python_source phase's training, predictions, serving and search
    py_counts = {}
    for counts in ([run["launches"] for run in python["train"].values()]
                   + [python["predict"]["launches"], python["serve"]["launches"]]
                   + [python["search"][b]["launches"] for b in ("exact", "ann")]):
        for key, n in counts.items():
            py_counts[key] = py_counts.get(key, 0) + n
    print(f"python_source launches: {json.dumps(py_counts)}")
    # the train_feed phase's runs (fused and pool_only, every feed)
    feed_counts = {}
    for run in feed_train["routes"].values():
        for key, n in run["launches"].items():
            feed_counts[key] = feed_counts.get(key, 0) + n
    print(f"train_feed launches: {json.dumps(feed_counts)}")
    el_counts = elastic["launches"]  # the train_elastic phase's runs (printed there)
    hpo_counts = searched["launches"]  # the train_hpo phase's trials and CLI run (printed there)
    mesh_counts = meshed["launches"]  # the train_mesh phase's runs, both ranks (printed there)
    at_counts = tuned["launches"]  # the autotune phase's search, auto training, serving, search
    line = []
    for name, rec in kernels.items():
        timed = next(r for r in rec["rows"] if (r["B"], r["L"]) == rec["timed"])
        line.append({
            "name": name, "route": "cuda", "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": (routes[rec["key"]]["launches"][rec["key"]]
                         + device_counts.get(rec["key"], 0) + var_counts.get(rec["key"], 0)
                         + py_counts.get(rec["key"], 0) + feed_counts.get(rec["key"], 0)
                         + control["launches"].get(rec["key"], 0)
                         + el_counts.get(rec["key"], 0) + hpo_counts.get(rec["key"], 0)
                         + mesh_counts.get(rec["key"], 0) + at_counts.get(rec["key"], 0)),
            "max_abs_err": max(r["max_abs_err"] for r in rec["rows"]),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
        })
    k5 = retrieval["k5_rows"]
    timed = next(r for r in k5 if (r["Q"], r["P"]) == K5_TIMED_SHAPE)
    print(f"launch floor ms={floor['ms']:.4f}; neighbors split: "
          f"{json.dumps(retrieval['neighbors_split'])}")
    line.append({
        "name": "K5 lut_score", "route": "cuda",
        "source": "code2vec_tpu_torch/csrc/lut_score.cu",
        "replaces": "code2vec_tpu/ann/lut_kernel.py:206",
        "launches": (retrieval["launches"]["lut_score"] + py_counts.get("lut_score", 0)
                     + control["launches"].get("lut_score", 0)
                     + at_counts.get("lut_score", 0) + mesh_counts.get("lut_score", 0)),
        "max_abs_err": max(r["max_abs_err"] for r in k5),
        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"], "library_ms": None,
    })
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            {"card": smi, "torch": torch.__version__, "launch_floor": floor, "kernels": kernels,
             "serve": serve,
             "longbag": longbag, "retrieval": retrieval, "serve_control": control,
             "train": trained, "train_elastic": elastic, "train_hpo": searched,
             "train_mesh": meshed, "autotune": tuned,
             "train_bucketed": bucketed, "train_bf16": bf16_train, "train_lazy": lazy_train,
             "train_device": device_train, "train_feed": feed_train, "extract": extracted,
             "train_variable": variable,
             "python_source": python},
            indent=1,
        ))
    for k in line:  # each kernel's share of its bound at its timed shape
        print(f"bound share {k['name']}: {k['bound_ms'] / k['ms']:.3f} "
              f"(ms={k['ms']:.5f} bound_ms={k['bound_ms']:.5f}, {k['bound_by']})")
    print(f"chip_smoke: the whole script took {time.perf_counter() - started:.1f} s "
          "(its limit 1200 s)", flush=True)
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
