#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bagua_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile] [--witness]

Phases, in order; the first that fails ends the run with a non-zero exit
and no result line:

1. device  -- a CUDA device must be visible; prints the card's name and
   power limit as ``nvidia-smi`` gives them.
2. build   -- builds the CUDA sources of ``bagua_tpu_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, in parallel).
3. kernels -- holds each kernel against its plain PyTorch version at the
   main paths' shapes, at ragged and at degenerate ones: the codec and hop
   kernels bitwise (VGG16's 10 MiB buckets over 4 ranks: ByteGrad's chunks
   and the quantized ring's blocks of 4096, where the int8 ring compresses
   and decompresses twice a step; those four calls are summed per int8-ring
   step on ``[kernels]`` lines of their own; the int4 block codec's two
   kernels at the int4 ring's same four calls, summed per int4-ring step as
   their own rows, at ragged blocks and on the degenerate rows; low-precision decentralized's
   whole-model row a rank, ``(4, 138,357,544)``, each 10 MiB bucket one
   row a rank as its overlap run compresses it, and a ragged ``(3, 2^27 +
   1)``, its compress and three decompresses summed per step, monolithic
   and overlap, on lines of their own), the three attention kernels
   within ATTENTION_TOLS (the Llama slice's half-blocks, 4 ranks folded
   into the batch, 32 heads of 128, at the zigzag ring's 2 sp + 1 calls a
   pass: the two diagonal blocks and the blocks wholly in the queries'
   past, whose key mask is expanded over the queries with stride 0; GQA,
   bf16 K/V, 200x300 with d 24 and 64, a fully masked block,
   first-key-only rows, a key mask expanded over the queries), the tile GEMM of the
   collective-matmul rings within ``matmul_tol`` of ``x @ w`` (path (a)'s
   five products, the backward's through transposed views, the rings'
   row-block views; edge shapes; a rank batch with a stride-0 operand),
   a tolerance that TF32-rounded inputs miss at path (a)'s shapes; bf16,
   f16 and f64 operands take ``x @ w`` with no launch (the reference's rule).
   Times them with CUDA events (the median of 5 batches of 10 back-to-back
   calls, each batch enqueued while the card is kept busy, after 3 warm-up
   calls) beside the least time the card could take (bytes over 3.35 TB/s,
   or operations over 67 TFLOP/s f32), summed over one step of its slice;
   the attention kernels also beside ``F.scaled_dot_product_attention`` on
   the same blocks (forward; forward + backward less the forward), the
   tile GEMM beside ``torch.matmul``.  Then the two rings at path (a)'s
   shapes: ``ag_matmul`` bidir bitwise equal to uni, both rings equal to
   ``allgather`` + matmul and ``allreduce`` + slice.
4. reference -- trains a small f32 VGG with ByteGrad, with the int8 ring,
   with the int4 ring, with the f32 wire and with ZeRO on each of the four,
   a small Llama over 4 zigzag ranks and at tp 2 x sp 2, and the fused
   sequence-parallel MLP pair at tp 4, on the card and on the CPU (plain
   versions) from the same weights and data, and holds each pair of runs'
   losses and parameters together within stated tolerances; the small
   VGG's runs but int4's take the overlap mode (the engine's default), and
   on the card (cuDNN deterministic, this phase only) they equal the
   monolithic runs bit for bit, and ZeRO's f32 and ByteGrad runs the
   unsharded f32 and ByteGrad runs; then decentralized SGD (``all``,
   ``shift_one``), low-precision decentralized and QAdam on the small VGG,
   card against CPU, each also with overlap on the card (bitwise equal to
   monolithic; low precision within ``LP_OVERLAP_TOL``); then stale-sync
   (τ 2) and gossip decentralized (``all``, ``shift_one``; τ 1) with rank
   2 under the degradation directive, card against CPU, the counters, and
   on the card overlap and τ=0 bitwise; the switch ``gradient_allreduce``
   -> ``zero`` bitwise equal on the card to a run that stayed unsharded.
5. slice   -- trains full-width VGG16 (224x224, 1000 classes, bf16
   compute, f32 parameters, batch 32 per rank) over 4 ranks on this one
   card through ``Trainer.fit`` with the monolithic step (``overlap=False``),
   5 steps each with ByteGrad (``intra_size=1``:
   every rank its own node, so the whole exchange is compressed) and with
   ``GradientAllReduceAlgorithm(wire_precision="int8")`` and ``"int4"``
   (flat: a ring of 4, 2 hops per bucket); then through the synthetic
   benchmark's twin (``examples/synthetic_benchmark.run``) with ByteGrad,
   the int8 ring and the f32 wire (``fuse="tuple"``), 5 steps monolithic
   and 5 with every bucket's exchange issued from inside the backward pass
   on a side stream (overlap), checking that each bucket is exchanged once
   a step in ``backward_order()``; then ZeRO through the twin (reduce-scatter,
   an optimizer step on each rank's shards, the parameters' all-gather at
   the next step's start): the f32 wire, ByteGrad and the int8 ring with
   overlap, ByteGrad and the int4 ring monolithic, 5 steps each, with the
   optimizer state per rank; then the decentralized pair and QAdam through
   the twin, 6 steps each (``DP_PATHS``: launches per step and bucket, the
   census, the algorithm state per rank); then the MNIST twin
   (``gradient_allreduce`` + Adam and ``"none"``); then the relaxations
   through the twin (``RELAX_PATHS``: stale and gossip with the directive,
   GradientAccumulation(ByteGrad, every=4), ``"none"`` and async, the
   switch ``gradient_allreduce`` -> ``zero`` -> ``bytegrad``; counters,
   exact launches, folds, no thread left, optimizer bytes); then Llama at ``llama_7b_config``'s
   width (2 layers, one sequence of 4096 tokens, f32) over 4 ranks, 5 AdamW
   steps of ``examples.llama_pretrain.train_step``, once as 4 zigzag ring
   ranks (sp 4) and once at tp 2 x sp 2 (path (b)); then path (a): the
   fused sequence-parallel MLP pair (``ColumnParallelDense(gather_input)``
   -> GELU -> ``RowParallelDense(scatter_output)``) at the 7B widths over
   tp 4, 5 SGD steps, held against the unfused pair, and one
   ``ParallelMLP(fused=True)`` against ``fused=False``.  Checks the loss
   is finite, the ranks' parameters are bitwise equal (Llama) and every
   kernel's launch count, per path.  ``--profile`` then traces one more
   step of each with ``torch.profiler``; for an overlap step also the
   exchange's kernel time (its side stream, found by marker kernels
   launched on it before and after the step) and the part of it that ran
   while a kernel of the main stream ran.
6. collectives -- (after the rings) every collective of the user API and
   every ``ReduceOp`` over 8 ranks of the card against the CPU, bitwise;
   ``functional.all_reduce``'s gradient; ``barrier`` waits for the card;
   the collectives twin on 4 ranks.
7. bert -- (after the slices) ``[bert-squad]``: rows 1-3 bitwise at every
   chunk shape of BERT-Large's SQuAD plan (timed per squad step), then
   the SQuAD twin at BERT-Large width (bf16, 4 ranks x 8 x 128 tokens,
   ``intra_size=1``, ByteGrad with overlap, Adam 3e-4), 2 warm-up and 5
   timed steps: ms/step, samples/s, peak memory, optimizer bytes, the
   plan, exactly one launch of each of rows 1-3 a bucket and step, the
   ranks' parameters bitwise equal; ``[bert-bench]``: the synthetic
   benchmark's ``bert-large`` line (32 a rank, SGD momentum) with
   ``gradient_allreduce`` and ByteGrad, the latter after rows 1-3 bitwise
   at every chunk shape of the MLM model's plan (timed per benchmark
   step), on that plan; ``[bert-sp]``: rows 6-8 at the
   sp blocks within ATTENTION_TOLS, then BERT-Large's encoder width (2
   layers, bf16, 2 x 512 tokens over sp 4, padding that leaves a block
   wholly padded), a forward and a backward through the kernels against
   the same pass through the plain block functions, with exact launches.
8. moe and resnet -- (after the BERT phases; no kernel of rows 1-9 runs
   here, and each phase checks that none is launched) ``[moe-ref]``: a
   small MoE, top-1 and top-2 with capacity truncation and ``used_token``,
   card against CPU (masks and ``tokens_per_expert`` equal, weights,
   outputs and gradients within stated f32 tolerances), ``a2a_chunks`` 2
   and 4 bitwise unchunked at ep 4 under ``vmap`` on the card, ep 4 against
   ep 1 with the experts tiled; ``[moe-bench]``: the ``bench_moe`` twin at
   full width (8 layers x 512, 8 experts top-2, vocab 8192, bf16, 4 ranks x
   32 x 128 tokens, ``intra_size=1``; ms/step, the samples/s/chip line,
   peak memory, every leaf bitwise equal across the ranks, a traced step
   under ``--profile``) and its fused all-to-all row (ep 4, 512 tokens a
   rank, chunks 1 and 4); ``[moe-example]``: the moe twin's ``main()`` at
   its defaults (non-expert leaves bitwise equal, expert leaves apart);
   ``[moe-async]`` (BASELINE config 5): that model with ``"async"`` at 50
   ms and the experts' ``dp_filter`` (at least one fold, no expert leaf
   averaged, finite losses, ms/step); ``[resnet]``: a small ResNet card
   against CPU (f64 losses and gradients under ``vmap``, and 2 f32
   decentralized engine steps against the CPU's engine and the f64
   recurrence; ``--witness`` adds the readings at batch 8 and 16 with
   cuDNN's default and deterministic algorithms), then ResNet-50 through the imagenet twin (BASELINE config
   4: 224x224, bf16, 4 ranks x 32) with ``gradient_allreduce`` and
   decentralized SGD, 2 + 5 steps each (img/s, ms/step, peak memory).
9. gpt -- (after ResNet) ``[gpt-ref]``: a small GPT (2 layers, hidden
   128, 2 heads of 64, 256 tokens) at sp 2 contiguous, sp 2 zigzag and
   tp 2, card against CPU and against the plain ring on the card (logits
   and every gradient, rows 6-8's launches exact), the three pipeline
   schedules on a small stage against the sequential program on the card,
   one FSDP step card against CPU; ``[gpt-pp]``: the gpt_pretrain twin at
   GPT-2 small's widths (2 stages of 6 blocks, pp 2 x sp 2 on the
   contiguous causal ring, 8 x 1024 tokens, 4 microbatches, f32, Adam
   1e-3), 2 warm-up and 5 timed steps with 1F1B and with GPipe (ms/step,
   tokens/s, peak memory, replicas bitwise, exact launches), rows 6-8
   within ATTENTION_TOLS at the twin's blocks and timed per step, and one
   traced 1F1B step (the card's idle share); ``[pp-mem]``: one step's peak
   memory at pp 4 (3 blocks a stage, 8 microbatches), 1F1B below GPipe or
   the run fails; ``[fsdp]``: ``GPTModel`` at GPT-2 small under ``FSDP``
   (bf16, 4 ranks x 4 x 1024 tokens, Adam), 2 + 5 steps, each rank's
   at-rest bytes against the total / 4, no sharded leaf held whole.
10. mesh -- (after FSDP) named meshes (``MeshSpec``): ``[mesh-ref]``: a
   small VGG on ``MeshSpec({"dp": 4})`` bitwise the legacy 4-rank group,
   and the two tp columns of ``dp 4 x tp 2`` bitwise that run (f32, the
   int8 ring, flat ByteGrad; monolithic and overlap; the codecs launched
   on two collectives of 4), then both twins' engine mode at the JAX
   tests' sizes on ``dp 4 x tp 2`` (overlap) and ``dp 4 x fsdp 2`` (ZeRO)
   card against CPU, with every exchange collective's axes read (``dp``
   only, some issued from autograd's thread); ``[mesh-llama]``: the Llama
   twin at its default dp 2 x tp 2 x sp 2, 7B width, 2 layers, 2 x 4096
   tokens, 5 AdamW steps (ms/step, tokens/s, peak memory, replicas
   bitwise, exact launches of rows 6-8, rows 6-8 at its blocks timed);
   ``[mesh-gpt]``: the gpt_pretrain twin at its default pp 2 x tp 2 x sp 2
   at GPT-2 small, 1F1B and GPipe, 2 + 5 steps (as ``[gpt-pp]``; the two
   schedules' losses agree); ``[mesh-engine]``: the twin's ``--engine``
   at GPT-2 small (12 blocks, 8 x 1024 tokens) on dp 4 x tp 2 with
   ``gradient_allreduce`` (overlap) and with ZeRO and on dp 4 x fsdp 2
   with ZeRO, 2 + 5 steps each (ms/step, tokens/s, peak memory, replicas
   bitwise, ZeRO's optimizer bytes a rank the plan's Adam state over the
   exchange size), then one flat-ByteGrad and one int8-ring step on dp 4
   x tp 2 with exact launches of rows 1-4, each held bitwise against its
   plain version on the inputs the step gave it and timed per step; the
   dp 4 x tp 2 ``gradient_allreduce`` engine then takes one step with a
   telemetry hub: every exchange record on ``["dp"]``, the step's bytes
   all on dp.
11. obs -- (after the mesh phases) observability.  The reference phase
   already held the small VGG (ByteGrad, the int8 ring, ZeRO; overlap,
   cuDNN deterministic) with every knob on bitwise equal to every knob
   off.  ``[obs]``: full-width VGG16 through ``Trainer.fit`` with overlap,
   ByteGrad and the int8 ring, three trainers (every knob off, the health
   monitor alone, every knob on: the telemetry hub with a JSONL stream, the
   flight recorder, the tracer and the regression sentinel, a goodput
   meter priced as VGG16, a health monitor), 2 warm-up steps each, then 5
   steps a turn in the order off, on, health, health, on, off: launches a
   turn equal SLICE_PATHS'; with everything on the flight records hold one
   exchange record a bucket and step in ``backward_order()`` with its
   spec's bytes and the data axes (the ring: an rs and an ag hop record a
   bucket, 3 hops each), all retired, the dump valid; the JSONL valid, one
   step event a step; no health alert, the monitor's loss the mean of the
   step's losses; one more step traced through ``ProfilerSession``:
   ``analyze_trace`` gives every bucket a row, and the kernels launched
   under an exchange label cover at least OBS_COVERAGE of the exchange
   stream's busy time.  Prints the three step times, MFU, goodput, both
   overlap measures and the flight records a step.
12. resil -- (after ``[obs]``) snapshots, the preemption drain, the
   elastic resume, checkpoints and the autotune service.  ``[resil-ref]``:
   the small VGG (cuDNN deterministic, SGD with momentum) with ByteGrad,
   the int8 ring and ZeRO f32: 6 steps uninterrupted; then 2 steps, a
   triggered preemption that drains step 3 and forces the final snapshot,
   and a fresh ``Trainer`` on the same directory that resumes at step 3
   and takes 3 more; every leaf (parameters, momentum, the algorithm's
   state) and each resumed loss bitwise the uninterrupted run's; ByteGrad
   again through ``ckpt_dir`` alone; the snapshot directory read with
   numpy (``leaf_keys`` and the leaf count as the CPU test pins them,
   :func:`resil_leaf_keys`); a cadence snapshot taken while the next step
   already updates the parameters in place holds the state of its own
   step.  ``[resil]``: full-width VGG16 over 4 ranks, ByteGrad with
   overlap, through ``Trainer.fit``: two trainers from the same weights,
   the snapshotter off and on (cadence 5, ``keep=1``, a temporary
   directory removed at the end), 5 warm-up steps each (through one
   snapshot), then 80 steps a turn (longer than a snapshot's write) in the
   order off, on, on, off, the writer never waited for between on-turns
   and idle before an off-turn, every turn's launches SLICE_PATHS' (a
   snapshot launches no codec); then a drain, a fresh ``Trainer`` that
   resumes with every leaf bitwise the drained one's, and one autotune
   session against an in-process ``AutotuneService`` on localhost that
   re-buckets the live engine, each step's launches exact for the plan it
   ran, the replicas bitwise equal.  No warning may be logged (the
   best-effort fallbacks log one).  Prints ms/step off and on, the on-turn
   steps that started with the writer busy, the clone's time on the card,
   the snapshot's wall time and bytes, the skipped cadence ticks, the
   drain's and the resume's wall times.
13. verify -- (after ``[resil]``) the static gate,
   ``BAGUA_STATIC_VERIFY=strict``: every kernel wrapper takes meta
   tensors to its plain version (no launch counted, nothing allocated on
   the card) and still launches on CUDA tensors; the small VGG's gate on
   each VERIFY_PATHS wire allocates and launches nothing; then full-width
   VGG16 over 4 ranks (``intra_size=1``, overlap as the engine resolves
   it) with f32 ``gradient_allreduce``, ByteGrad, the int8 ring and ZeRO
   int8 through ``Trainer.fit``, the gate off and then strict, 1 +
   VERIFY_STEPS steps each: around every gate (:class:`GateWatch`) no
   launch, ``torch.cuda.memory_allocated`` unchanged, no allocation, the
   report ok; launches exact and equal with the gate off; for the modeled
   algorithms the flight capture equal to the prediction; a rebucket
   re-verified, a planted rejection rolled back, one step on the new plan
   with exact launches; ``model_step_cell`` beside the measured step.
   Prints each gate's host ms, the first and the later steps with the gate
   on and off, and the modeled step.
14. autopilot -- the ``Trainer`` with a ``GangAutopilot`` (int8/f32 over
   ``wire_precision="auto"``, the telemetry's ``RegressionSentinel`` as
   its sentinel, fed the JAX tests' incident shape) under the strict gate
   at full-width VGG16: a planted rejection of the first demotion,
   counted and recorded, with the next steps launching no codec; then a
   demotion to the int8 ring re-verified and dispatched, each step's
   launches row 4's exactly, and the canary committed (or rolled back)
   after 3 steps.  Prints the decision rows and the gates' host ms.
15. fleet -- the fleet control plane (``bagua_tpu_torch.fleet``) in this
   process: an ``AsyncFleetServer`` on 127.0.0.1 over a write-ahead log in
   a temporary directory.  Gang ``alpha`` (full-width VGG16, 4 ranks x 32,
   ``intra_size=1``, bf16, ByteGrad with overlap, FLEET_ALPHA_BUCKET-byte
   buckets) trains under an ``AutotuneSession`` whose client is
   ``FleetClient.autotune_client("alpha")`` until the gang's own autotune
   service re-buckets it, takes FLEET_STEPS timed steps and publishes its
   plan; gang ``beta``, a fresh ``Trainer`` at the default bucket size,
   adopts it at step 0 through ``ElasticResumeCoordinator(fleet_plan_fn=...)``
   (``"fleet"``, one rebucket, a ``restart`` event with
   ``plan_source="fleet"``), its buckets alpha's, its first step and
   FLEET_STEPS timed ones launching rows 1-3 exactly at that plan's bucket
   count.  Then incidents
   that cite the plan quarantine it through ``FleetClient.remediate()``,
   beta's ``fleet_directive()`` is the ``rollback_plan`` directive and beta
   acks it; the plane, closed and rebuilt from its log, has the same dump,
   plan statuses, directives and scheduler view (but FLEET_VOLATILE's
   fields, which a restart resets by design), and a third gang is
   refused the quarantined plan; ``run_fleet`` through the plane's
   namespaces flags its injected straggler in every window.  No card
   memory is left allocated.  Prints both gangs' ms/step and the
   adoption's and the replay's wall times.
16. fleet-gang -- gang beta as launcher workers in a fleet namespace: a
   plane in this process (no WAL) holds the plan ``[fleet]``'s alpha
   published (``phase_fleet`` returns it); ``W = device_count()`` workers (at most 4,
   a divisor of 4) of ``examples/fleet_gang.py`` under ``python -m
   bagua_tpu_torch.distributed.run --rdzv_endpoint <base>/g/beta
   --max_restarts 1`` form the gang over NCCL (even at W = 1), each holding
   ``4 / W`` ranks on ``cuda:LOCAL_RANK``, and train full-width VGG16 (bf16,
   32 a rank, ByteGrad with overlap, seed-0 weights, the synthetic batch)
   under the ``Trainer`` with a snapshot every FLEET_GANG_EVERY steps.
   Every process adopts alpha's plan at step 0 (``fleet_warm_start``
   under the gang's identity); the first attempt runs FLEET_GANG_CRASH
   steps, waits for the complete snapshot at step FLEET_GANG_EVERY and
   exits hard (``os._exit``); the launcher restarts the gang, which agrees
   on that step (through the namespace's KV at W > 1), resumes with the
   plan carried and runs to FLEET_GANG_STEPS.  Gates: each process ran
   alpha's bucket names in both attempts; rows 1-3 launched exactly
   (steps run x buckets x per bucket, over both attempts); each attempt's
   first launches bitwise their plain versions; the resume step is
   FLEET_GANG_EVERY; every step's losses and the final parameters bitwise
   those of an in-process single-controller run of FLEET_GANG_STEPS steps
   on the same plan, weights and batches; the plane's scheduler view
   shows W processes reporting and the plan's status beta once among its
   adopters and its canary cohort.  Prints the gang's ms/step against the
   single controller's (which snapshots at the same cadence; the median
   and the mean of steps 2 to FLEET_GANG_CRASH, the steps that started
   with the snapshot's writer busy, and how far the pinned host allocator
   grew during each step), the adoption's ms, the resume's wall
   ms and bytes, the launches and the card's name and power limit.
17. sync-bn -- SyncBatchNorm: the small ResNet with ``sync_bn=True`` on the
   card against the CPU (f64 losses, gradients and statistics under a
   ``vmap`` over 4 ranks, the statistics the same on every rank; 2 f32
   ``gradient_allreduce`` engine steps, cuDNN deterministic); then
   ResNet-50 (224x224, bf16, 4 ranks x 32, ``gradient_allreduce``) under the
   engine with ``sync_bn=False`` and ``True``, RESNET_WARMUP + 5 steps each:
   ms/step, img/s, peak memory and the statistics' collectives a step (one
   a norm, 53 norms).  No kernel runs.
18. contrib -- the native tier: an ``ShmStore`` segment written here and
   read by a ``spawn`` child (which writes back); a ``RendezvousStore`` and
   a two-server cluster store against live rendezvous servers of the port;
   the ``IOPrefetcher`` streaming CONTRIB_FILES generated files in order,
   their bytes equal; a ``CachedDataset`` over ``SyntheticImageNet`` on the
   ``"shm"`` backend feeding two ResNet-50 ``sync_bn=True`` steps, its
   batches bitwise the memory backend's.  The imagenet twin's
   ``--data-dir`` is not driven: PIL is not installed where the card is
   (the CPU tests drive it).  No kernel runs.
19. dist -- a group that spans processes: ``W = torch.cuda.device_count()``
   worker processes (at most 4, a divisor of 4) through the
   launcher (``python -m bagua_tpu_torch.distributed.run --nproc_per_node
   W``) running ``examples/gang.py``: each forms the gang over NCCL at
   the launcher's coordinator (even at W = 1, so every collective goes
   through ``torch.distributed``), holds ``4 / W`` of the usual 4 ranks
   (``intra_size=1``) on ``cuda:LOCAL_RANK`` and trains full-width VGG16
   (32 a rank, bf16, 10 MiB buckets, seed-0 weights, the synthetic batch,
   each process its own rows) for 1 + 5 steps under DIST_CASES: f32
   ``gradient_allreduce``, ByteGrad with overlap, the int8 ring, ZeRO
   over the int8 ring, decentralized ``shift_one``, low-precision
   decentralized and QAdam (``QADAM_FULL``; its 2 warm-up steps, which
   launch nothing, join the gang's warm-up), its warm-up steps holding
   each codec and hop kernel it launches against the plain version on the
   same inputs (bitwise; the wrappers record their first launch,
   ``kernels._build.WITNESS``).  Every worker must exit 0; each process's
   parameters must be bitwise the single-controller 4-rank run's rows (the
   same cases in this process on ``cuda:0``) and, but for the
   decentralized pair, equal across processes, rows 1-4 launched exactly
   ``steps x buckets x`` the wire's count a process (QAdam's compressing
   steps only), and no rank on the CPU.  Then the twin paths of
   DIST_TWINS the same way, each a gang sharing its mesh's ranks: path
   (a), the Llama twin's hand-scheduled step at ``llama_7b_config``'s
   width (2 layers, one 4096-token sequence, f32, AdamW) on tp 2 x sp 2,
   the zigzag ring through rows 6-8 and the Row projections fused through
   row 9; path (b), the GPT twin's engine at GPT-2 small on dp 4 x tp 2
   (``gradient_allreduce`` with overlap, ``1 << 14``-byte buckets, Adam);
   1 + 5 steps for path (a), 2 + 5 for path (b), whose single-controller
   run is ``[mesh-engine]``'s of the same case (same flags, weights,
   batches and steps: its digests, launches and ms/step are kept, not
   run twice).  Each process's parameters must be bitwise the
   single controller's rows, its launches of rows 1-9 exactly the single
   controller's (path (a) launching each of rows 6-9), and the first
   launch of each of rows 6-9 within ``ATTENTION_TOLS`` or ``matmul_tol``
   of its plain version; path (a)'s first-step losses must be within
   1e-5 relative of the unfused model's (``tp_fused`` off, run here on
   the single controller: the fused Row layers against the ``psum``
   path).  Prints, per wire and path, W, ms/step beside
   the single-controller run's, the bytes a step each process sent to
   other processes and to itself, and the card's name and power limit.
20. prints one JSON line naming each kernel with its launches and times
   (``other_steps``: the sums per step of other paths, the BERT, GPT and
   mesh ones included), then the result line ``{"ok": true, "device":
   {...}}``.
"""

import contextlib
import copy
import dataclasses
import functools
import gc
import itertools
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import bagua_tpu_torch as bagua
from bagua_tpu_torch import BaguaProcessGroup, init_process_group
from bagua_tpu_torch.algorithms import (
    ByteGradAlgorithm, DecentralizedAlgorithm, GradientAccumulation, GradientAllReduceAlgorithm, build_algorithm,
    LowPrecisionDecentralizedAlgorithm, QAdamAlgorithm, QAdamOptimizer, StaleSyncAlgorithm,
)
from bagua_tpu_torch.algorithms.base import StepContext
from bagua_tpu_torch.ddp import DistributedDataParallel, state_leaves
from bagua_tpu_torch.examples import gpt_pretrain as gp
from bagua_tpu_torch.examples import llama_pretrain as lp
from bagua_tpu_torch.examples import bench_moe, communication_primitives, gang, imagenet, mnist, moe, squad
from bagua_tpu_torch.examples import synthetic_benchmark as sb
from bagua_tpu_torch.communication import allgather, allreduce, hierarchical_allreduce, reduce_scatter
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import collective_matmul as cm
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.kernels import quantized_ring as qr
from bagua_tpu_torch.kernels.tolerance import ATTENTION_TOLS, close, matmul_share, matmul_tol
from bagua_tpu_torch.mesh import MeshSpec
from bagua_tpu_torch.functional import all_reduce as functional_all_reduce
from bagua_tpu_torch.models import bert as bert_model
from bagua_tpu_torch.models.bert import BertModel, bert_large_config, init_bert
from bagua_tpu_torch.models.gpt import GPTConfig, GPTModel, init_gpt, lm_loss_fn as gpt_lm_loss_fn
from bagua_tpu_torch.models.resnet import ResNet, init_resnet, resnet_loss_fn
from bagua_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_llama, llama_7b_config, llama_loss_fn
from bagua_tpu_torch.models.vgg import VGG, init_vgg16, module_params, vgg16, vgg_loss_fn
from bagua_tpu_torch.observability import (
    GoodputMeter, HealthMonitor, ProfilerSession, RegressionSentinel, Telemetry, Tracer, analyze_trace,
    attribute_device_events, flight_dump_path, load_trace_events, model_flops_per_sample, parse_exchange_label,
    validate_flight_dump, validate_metrics_file,
)
from bagua_tpu_torch.observability.flight_recorder import FlightRecorder
from bagua_tpu_torch.observability.health import grad_norms
import bagua_tpu_torch.analysis as tan
from bagua_tpu_torch.parallel import pipeline as pl
from bagua_tpu_torch.parallel.fsdp import FSDP, fsdp_shardings
from bagua_tpu_torch.parallel.moe import MoE
from bagua_tpu_torch.parallel.ring_attention import ring_attention, zigzag_order
from bagua_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense, ParallelMLP, RowParallelDense, gelu,
)
from bagua_tpu_torch.sharded import ZeroAlgorithm
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_map, tree_unflatten

RANKS = 4
STEPS = 5
BATCH_PER_RANK = 32
IMAGE_SIZE = 224
NUM_CLASSES = 1000
BLOCK = qr.DEFAULT_BLOCK
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BUSY_CYCLES = 40_000_000  # about 20 ms of the card's clock: longer than enqueueing a timed batch
MM8_SOURCE = "bagua_tpu_torch/kernels/csrc/minmax_uint8.cu"
QR_SOURCE = "bagua_tpu_torch/kernels/csrc/quantized_ring.cu"
FA_SOURCE = "bagua_tpu_torch/kernels/csrc/flash_attention.cu"
FA_TPU = "bagua_tpu/kernels/flash_attention.py"
CM_SOURCE = "bagua_tpu_torch/kernels/csrc/collective_matmul.cu"
KERNELS = {
    # name: (wrapper, plain version, source, TPU kernel it replaces)
    "compress_minmax_uint8": (
        mm8.compress_minmax_uint8, mm8.compress_minmax_uint8_plain, MM8_SOURCE,
        "bagua_tpu/kernels/minmax_uint8.py:195",
    ),
    "decompress_minmax_uint8": (
        mm8.decompress_minmax_uint8, mm8.decompress_minmax_uint8_plain, MM8_SOURCE,
        "bagua_tpu/kernels/minmax_uint8.py:232",
    ),
    "decompress_reduce_requantize": (
        mm8.decompress_reduce_requantize, mm8.decompress_reduce_requantize_plain, MM8_SOURCE,
        "bagua_tpu/kernels/minmax_uint8.py:318",
    ),
    "hop_dequant_add_requant_int8": (
        functools.partial(qr.hop_dequant_add_requant, bits=8),
        functools.partial(qr.hop_dequant_add_requant_plain, bits=8), QR_SOURCE,
        "bagua_tpu/kernels/quantized_ring.py:200",
    ),
    "hop_dequant_add_requant_int4": (
        functools.partial(qr.hop_dequant_add_requant, bits=4),
        functools.partial(qr.hop_dequant_add_requant_plain, bits=4), QR_SOURCE,
        "bagua_tpu/kernels/quantized_ring.py:211",
    ),
    # the int4 block codec: no Pallas kernel, jnp in the JAX package
    "compress_minmax_uint4": (
        qr.compress_minmax_uint4, qr.compress_minmax_uint4_plain, QR_SOURCE,
        "bagua_tpu/kernels/quantized_ring.py:101 (jnp)",
    ),
    "decompress_minmax_uint4": (
        qr.decompress_minmax_uint4, qr.decompress_minmax_uint4_plain, QR_SOURCE,
        "bagua_tpu/kernels/quantized_ring.py:125 (jnp)",
    ),
    "block_attention": (fa.block_attention, fa.block_attention_plain, FA_SOURCE, f"{FA_TPU}:314"),
    "flash_attention_bwd_dq": (
        fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain, FA_SOURCE, f"{FA_TPU}:510",
    ),
    "flash_attention_bwd_dkv": (
        fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_plain, FA_SOURCE, f"{FA_TPU}:543",
    ),
    "matmul_tile": (
        cm.matmul_tile, cm.matmul_tile_plain, CM_SOURCE, "bagua_tpu/kernels/collective_matmul.py:299",
    ),
}


def reset_launches() -> None:
    for fn in mm8.KERNELS + qr.KERNELS + fa.KERNELS + cm.KERNELS:
        fn.launches = 0
    qr.hop_dequant_add_requant.launches_by_bits.update({8: 0, 4: 0})


def read_launches() -> dict:
    """Each kernel's launches since :func:`reset_launches`, by KERNELS name."""
    counts = {fn.__name__: fn.launches for fn in mm8.KERNELS + qr.CODEC4 + fa.KERNELS + cm.KERNELS}
    for bits, n in qr.hop_dequant_add_requant.launches_by_bits.items():
        counts[f"hop_dequant_add_requant_int{bits}"] = n
    return counts


_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line, with the seconds since the script started."""
    print(f"{msg} [{time.perf_counter() - _START:.1f} s]", flush=True)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal; NaNs count as equal to NaNs whatever their payload."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]
    )


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok] - b[ok]).abs().max()) if ok.any() else 0.0


def median_ms(fn, reps: int = 5, calls: int = 10, warm: int = 3) -> float:
    """The card's time for one call of ``fn``: the median over ``reps``
    batches of ``calls`` back-to-back calls.  Each batch is enqueued while
    the card spins (``BUSY_CYCLES``), so the card runs the calls without
    waiting for the host between them: a wrapper's host time is hidden, as
    it is on the main path, where the host runs ahead of the card."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BUSY_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


class Ledger:
    """Per kernel: comparisons made, worst error, summed times per step."""

    def __init__(self):
        self.rows = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                bound_by="bytes", library_ms=None, checks=0) for name in KERNELS}
        #: sums over the steps of other slices than the kernel's own:
        #: step -> kernel -> {ms, plain_ms, bound_ms}
        self.other_steps = {}

    def compare(self, name: str, case: str, *args, **kwargs):
        """The kernel against its plain version: bitwise, or within
        ATTENTION_TOLS for the attention kernels."""
        wrapper, plain, _, _ = KERNELS[name]
        got, want = wrapper(*args, **kwargs), plain(*args, **kwargs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        row = self.rows[name]
        row["checks"] += 1
        tols = ATTENTION_TOLS.get(name, (None,) * len(got))
        for g, w, tol in zip(got, want, tols):
            row["max_abs_err"] = max(row["max_abs_err"], abs_err(g, w))
            ok = same(g, w) if tol is None else g.shape == w.shape and g.dtype == w.dtype and close(g, w, tol)
            if not ok:
                raise AssertionError(f"{name} differs from its plain version on {case} "
                                     f"(max abs error {abs_err(g, w):.3e}, tolerance {tol})")
        return got if len(got) > 1 else got[0]

    def compare_matmul(self, case: str, x: torch.Tensor, w: torch.Tensor) -> float:
        """The tile kernel against ``x @ w`` (TF32 off): every element within
        ``matmul_tol(K)`` times ``(|x| |w|)`` there.  Returns the largest
        share of that bound an element used."""
        got, want = cm.matmul_tile(x, w), cm.matmul_tile_plain(x, w)
        torch.cuda.synchronize()
        row = self.rows["matmul_tile"]
        row["checks"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], abs_err(got, want))
        share = matmul_share(got, want, x, w)
        if got.shape != want.shape or share > 1.0:
            raise AssertionError(f"matmul_tile differs from x @ w on {case}: max abs error "
                                 f"{abs_err(got, want):.3e}, {share:.3f} of the bound "
                                 f"{matmul_tol(x.shape[-1]):.3e} (|x| |w|)")
        return share

    def time(self, name: str, nbytes: int, ops: int, *args, per_step: int = 1, library=None,
             step=None, **kwargs):
        """Times one call; adds ``per_step`` times it (the calls one step
        makes at this shape) to the kernel's per-step sums, or, where
        ``step`` names another slice's step, to ``other_steps[step]``.
        ``library``: a callable whose time is the library call's for the
        same work."""
        wrapper, plain, _, _ = KERNELS[name]
        row = self.rows[name] if step is None else self.other_steps.setdefault(step, {}).setdefault(
            name, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None))
        ms = median_ms(lambda: wrapper(*args, **kwargs))
        plain_ms = median_ms(lambda: plain(*args, **kwargs))
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        row["ms"] += per_step * ms
        row["plain_ms"] += per_step * plain_ms
        row["bound_ms"] += per_step * max(bytes_ms, ops_ms)
        if ops_ms > bytes_ms and step is None:
            row["bound_by"] = "operations"
        if library is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + per_step * library()
        return ms, plain_ms, max(bytes_ms, ops_ms)


def peak_memory() -> str:
    """The card's peak allocation since the last reset, in GiB and bytes."""
    peak = torch.cuda.max_memory_allocated()
    return f"{peak / 2**30:.2f} GiB ({peak} B)"


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 mantissa bits (to nearest, ties to even),
    as a tensor-core kernel reads f32 operands."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)  # as nvidia-smi gives it
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build(["minmax_uint8", "quantized_ring", "flash_attention", "collective_matmul"])
    for name, path, seconds in built:
        with open(f"{path}.log") as f:
            regs = [line.split("ptxas info    : ")[-1] for line in f if "registers" in line]
        log(f"[build] {name}.cu in {seconds:.1f} s -> {path}; ptxas: {' | '.join(regs)}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s")


def slice_shapes(plan):
    """(numel, chunk) of each bucket exchanged over RANKS ranks."""
    return [(spec.numel, spec.numel // RANKS) for spec in plan.specs]


def pipeline_inputs(x: torch.Tensor, n: int):
    """ByteGrad's three kernel inputs for stacked flats ``x`` (R, n*chunk):
    what compress, the fused reduce and decompress see in one exchange."""
    ranks, chunk = x.shape[0], x.shape[1] // n
    q, mm = mm8.compress_minmax_uint8_plain(x.reshape(ranks * n, chunk))
    q_recv = q.reshape(ranks, n, chunk).transpose(0, 1).contiguous()
    mm_recv = mm.reshape(ranks, n, 2).transpose(0, 1).contiguous()
    q2, mm2 = mm8.decompress_reduce_requantize_plain(q_recv, mm_recv)
    qg = q2.reshape(1, n * chunk).expand(ranks, -1).reshape(ranks * n, chunk).contiguous()
    mmg = mm2.reshape(1, n * 2).expand(ranks, -1).reshape(ranks * n, 2).contiguous()
    return x.reshape(ranks * n, chunk), (q_recv, mm_recv), (qg, mmg)


def ring_codec_inputs(x: torch.Tensor, block: int, bits: int = 8):
    """The ``bits`` ring's codec inputs for stacked flats ``x`` (R, L) over R
    ranks, each blocked as ``quantized_ring._pad_to_blocks`` pads it: the
    reduce-scatter's step-0 blocks (rank i's shard (i - 1) mod R) and the
    all-gather's shard blocks (the shards' sums), which it compresses; the
    reduce-scatter's one decompress (its step-0 and arrived packages, 2
    blocks a block) and the all-gather's (every rank's copy of all R
    shards' packages)."""
    ranks = x.shape[0]
    shards = x.reshape(ranks, ranks, -1)
    idx = torch.arange(ranks, device=x.device)
    blocks = lambda t: qr._pad_to_blocks(t, block)[0].reshape(-1, block)
    local0, owned = blocks(shards[idx, (idx - 1) % ranks]), blocks(shards.sum(0))
    q, mm = qr._compressors(bits, plain=True)[0](torch.cat([local0, owned]))
    rows = owned.shape[0]
    return (local0, owned), (q, mm), (q[rows:].repeat(ranks, 1), mm[rows:].repeat(ranks, 1))


#: rows that send the int4 compress down its exact branch (a NaN or an
#: infinity) or need XLA's min/max order (-0 below +0)
INT4_CORNERS = ("+inf", "-inf", "both infinities", "one +inf", "one -inf", "NaN in the first column",
                "NaN in the low half", "all NaN", "min -0, max +0")


def int4_corner_row(case: str, block: int, device) -> torch.Tensor:
    """The row of INT4_CORNERS named ``case``, ``block`` elements; a single
    inf or NaN sits in a ramp from -3 to 3."""
    inf, nan = float("inf"), float("nan")
    row = torch.linspace(-3.0, 3.0, block, device=device)
    if case in ("+inf", "-inf", "all NaN"):
        row.fill_({"+inf": inf, "-inf": -inf, "all NaN": nan}[case])
    elif case in ("both infinities", "min -0, max +0"):
        row[::2], row[1::2] = (inf, -inf) if case == "both infinities" else (-0.0, 0.0)
    else:
        col, value = {"one +inf": (block // 2 + 1, inf), "one -inf": (block // 2 + 1, -inf),
                      "NaN in the first column": (0, nan), "NaN in the low half": (3 * block // 8, nan)}[case]
        row[col] = value
    return row


def codec_cost(rows: int, chunk: int, ops_per_element: int, bits: int = 8):
    """(bytes, f32 operations) of compress or decompress over (rows, chunk)
    f32 elements: 4 bytes an element, its ``bits`` of level and the 8-byte
    sidecar a row, each moved once."""
    return rows * chunk * (32 + bits) // 8 + rows * 8, rows * chunk * ops_per_element


def hop_inputs(incoming: torch.Tensor, local: torch.Tensor, block: int, bits: int):
    """The hop's inputs for every rank's shard, ``(RANKS, S)`` each, padded
    to blocks as the ring pads them: the incoming packages (compressed by
    the plain codec) and the local partials."""
    comp, _ = qr._compressors(bits, plain=True)
    blocks = lambda t: qr._pad_to_blocks(t, block)[0].reshape(-1, block)
    q, mm = comp(blocks(incoming))
    return q, mm, blocks(local)


def hop_cost(rows: int, bits: int):
    """(bytes, f32 operations) of one hop call over ``rows`` blocks: q, the
    sidecar and the local partial read once, q2, its sidecar and err
    written once; about 12 operations per element."""
    cols = BLOCK if bits == 8 else BLOCK // 2
    return rows * (2 * cols + 2 * BLOCK * 4 + 16), rows * BLOCK * 12


def phase_kernels(ledger: Ledger, plan, device) -> None:
    gen = torch.Generator(device=device).manual_seed(1)
    # the main paths' shapes: every bucket of VGG16 over 4 ranks, timed
    for numel, chunk in slice_shapes(plan):
        x = torch.randn((RANKS, numel), generator=gen, device=device) * 1e-3
        flat, fused_in, dec_in = pipeline_inputs(x, RANKS)
        rows = RANKS * RANKS
        case = f"bucket of {numel} elements"
        ledger.compare("compress_minmax_uint8", case, flat)
        ledger.compare("decompress_reduce_requantize", case, *fused_in)
        ledger.compare("decompress_reduce_requantize", case + " (sum)", *fused_in, average=False)
        ledger.compare("decompress_minmax_uint8", case, *dec_in)
        t = {
            "compress": ledger.time("compress_minmax_uint8", *codec_cost(rows, chunk, 6), flat),
            "fused reduce": ledger.time("decompress_reduce_requantize",
                                        rows * chunk + rows * 8 + RANKS * (chunk + 8),
                                        rows * chunk * 3 + RANKS * chunk * 5, *fused_in),
            "decompress": ledger.time("decompress_minmax_uint8", *codec_cost(rows, chunk, 2), *dec_in),
        }
        # ZeRO's ByteGrad decompresses each rank's own reduced chunk only
        own = [a.reshape(RANKS, -1) for a in mm8.decompress_reduce_requantize_plain(*fused_in)]
        ledger.compare("decompress_minmax_uint8", f"{case}, ZeRO's own chunk", *own)
        t["decompress, ZeRO's own chunk"] = ledger.time(
            "decompress_minmax_uint8", *codec_cost(RANKS, chunk, 2), *own, step="ZeRO ByteGrad")
        del flat, fused_in, dec_in, own
        # low-precision decentralized with overlap: the bucket one row a rank,
        # one compress and three decompresses a step
        lp = f"{case}, low-precision overlap row"
        q, mm = ledger.compare("compress_minmax_uint8", lp, x)
        ledger.compare("decompress_minmax_uint8", lp, q, mm)
        step = "low-precision decentralized (overlap)"
        t["compress, low-precision overlap row"] = ledger.time(
            "compress_minmax_uint8", *codec_cost(RANKS, numel, 6), x, step=step)
        t["decompress, low-precision overlap row"] = ledger.time(
            "decompress_minmax_uint8", *codec_cost(RANKS, numel, 2), q, mm, per_step=3, step=step)
        del q, mm
        # the int8 ring's codec calls, one of each a step at this bucket
        comp_in, rs_dec, ag_dec = ring_codec_inputs(x, BLOCK)
        for what, blocks in zip(("reduce-scatter step 0", "all-gather"), comp_in):
            ledger.compare("compress_minmax_uint8", f"{case}, int8 ring {what}", blocks)
            t[f"compress, int8 ring {what}"] = ledger.time(
                "compress_minmax_uint8", *codec_cost(*blocks.shape, 6), blocks, step="int8 ring")
        for what, dec in (("reduce-scatter", rs_dec), ("all-gather", ag_dec)):
            ledger.compare("decompress_minmax_uint8", f"{case}, int8 ring {what}", *dec)
            t[f"decompress, int8 ring {what}"] = ledger.time(
                "decompress_minmax_uint8", *codec_cost(*dec[0].shape, 2), *dec, step="int8 ring")
        del comp_in, rs_dec, ag_dec
        # the int4 ring's codec calls, one of each a step at this bucket: the
        # codec kernels' own rows, summed per int4-ring step
        comp_in, rs_dec, ag_dec = ring_codec_inputs(x, BLOCK, bits=4)
        for what, blocks in zip(("reduce-scatter step 0", "all-gather"), comp_in):
            ledger.compare("compress_minmax_uint4", f"{case}, int4 ring {what}", blocks)
            t[f"compress int4, int4 ring {what}"] = ledger.time(
                "compress_minmax_uint4", *codec_cost(*blocks.shape, 6, bits=4), blocks)
        for what, dec in (("reduce-scatter", rs_dec), ("all-gather", ag_dec)):
            ledger.compare("decompress_minmax_uint4", f"{case}, int4 ring {what}", *dec)
            t[f"decompress int4, int4 ring {what}"] = ledger.time(
                "decompress_minmax_uint4", *codec_cost(dec[0].shape[0], 2 * dec[0].shape[1], 2, bits=4), *dec)
        del comp_in, rs_dec, ag_dec
        # the ring's hop: each rank's shard of chunk elements in blocks, the
        # incoming partial sum of a few ranks' gradients and the local one
        incoming = x[:, :chunk] + x[:, chunk:2 * chunk]
        for bits in (8, 4):
            name = f"hop_dequant_add_requant_int{bits}"
            q, mm, local = hop_inputs(incoming, x[:, 2 * chunk:3 * chunk], BLOCK, bits)
            ledger.compare(name, case, q, mm, local)
            t[f"hop int{bits}"] = ledger.time(name, *hop_cost(local.shape[0], bits), q, mm, local,
                                              per_step=RANKS - 2)
            del q, mm, local
        if numel == max(s[0] for s in slice_shapes(plan)):
            for name, (ms, plain_ms, bound_ms) in t.items():
                log(f"[kernels] {case}, chunk {chunk}: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms")
    # ragged chunks
    for chunk in (7, 4095, 65539):
        x = torch.randn((RANKS, RANKS * chunk), generator=gen, device=device) * 3.0
        flat, fused_in, dec_in = pipeline_inputs(x, RANKS)
        ledger.compare("compress_minmax_uint8", f"chunk {chunk}", flat)
        ledger.compare("decompress_reduce_requantize", f"chunk {chunk}", *fused_in)
        ledger.compare("decompress_minmax_uint8", f"chunk {chunk}", *dec_in)
    # ragged blocks, with a last shard that is not a whole number of blocks
    for block in (2, 6, 130, 4098, 65538):
        shard = 3 * block + 1
        x = torch.randn((2, RANKS, shard), generator=gen, device=device)
        for bits in (8, 4):
            ledger.compare(f"hop_dequant_add_requant_int{bits}", f"block {block}",
                           *hop_inputs(x[0], x[1], block, bits))
        packed, mm4 = ledger.compare("compress_minmax_uint4", f"block {block}",
                                     qr._pad_to_blocks(x[0], block)[0].reshape(-1, block))
        ledger.compare("decompress_minmax_uint4", f"block {block}", packed, mm4)
    # degenerate inputs (tests/test_bytegrad.py:87-236), a NaN, signed zeros
    cases = {f"constant {v}": torch.full((4, 4096), v, device=device)
             for v in (0.0, 1.5, 2.5, -7.0, 1e32, -1e35, 3.4e38, 8.8e33)}
    mixed = torch.randn((4, 4096), generator=gen, device=device)
    mixed[1], mixed[3] = 0.0, -2.5e33
    cases["mixed"] = mixed
    cases["constant 1.7e33, chunk 129"] = torch.full((5, 129), 1.7e33, device=device)
    nan = torch.randn((3, 258), generator=gen, device=device)
    nan[1, 100] = float("nan")
    cases["one NaN"] = nan
    cases["signed zeros"] = torch.tensor(
        [[0.0, -0.0, 1.0, 2.0], [-0.0, 0.0, 1.0, 2.0], [-1.0, 0.0, -0.0, -2.0],
         [-1.0, -0.0, 0.0, -2.0], [-0.0] * 4, [0.0] * 4], device=device)
    for case, x in cases.items():
        q, mm = ledger.compare("compress_minmax_uint8", case, x)
        ledger.compare("decompress_minmax_uint8", case, q, mm)
        for average in (True, False):
            ledger.compare("decompress_reduce_requantize", case, q[None], mm[None], average=average)
        for bits in (8, 4):
            # the same block as incoming sum and as local partial: a constant
            # sum requantizes where upper - levels may round
            ledger.compare(f"hop_dequant_add_requant_int{bits}", case,
                           *hop_inputs(x, x, x.shape[1] + x.shape[1] % 2, bits))
        # the int4 codec on the same rows, an odd row's last value repeated
        # (B must be even), so a constant row stays constant
        blocks4 = torch.cat([x, x[:, -1:]], 1) if x.shape[1] % 2 else x
        packed, mm4 = ledger.compare("compress_minmax_uint4", case, blocks4)
        ledger.compare("decompress_minmax_uint4", case, packed, mm4)
    # the int4 codec on INT4_CORNERS, each the middle row of three random
    # ones, at compress's vector resident (4096), scalar (258) and walking
    # (8192) widths
    for block in (4096, 258, 8192):
        for case in INT4_CORNERS:
            x = torch.randn((3, block), generator=gen, device=device) * 3.0
            x[1] = int4_corner_row(case, block, device)
            packed, mm4 = ledger.compare("compress_minmax_uint4", f"{case}, B={block}", x)
            ledger.compare("decompress_minmax_uint4", f"{case}, B={block}", packed, mm4)
    phase_lp_kernels(ledger, plan, device, gen)
    for name, row in ledger.rows.items():
        if name in ATTENTION_TOLS or name == "matmul_tile":
            continue
        step = " int4-ring" if name.endswith("minmax_uint4") else ""
        log(f"[kernels] {name}: {row['checks']} comparisons bitwise, per{step} step over "
            f"{plan.num_buckets} buckets {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms)")
    for step, sums in ledger.other_steps.items():
        over = "one bucket" if step == "low-precision decentralized" else f"{plan.num_buckets} buckets"
        for name, row in sums.items():
            log(f"[kernels] {name} per {step} step over {over} {row['ms']:.4f} ms "
                f"(plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms)")


def lp_row_elements(plan) -> int:
    """Elements of low-precision decentralized's one bucket for the model
    of ``plan``: every parameter, padded to the RANKS ranks."""
    total = sum(s.numel for spec in plan.specs for s in spec.slots)
    return -(-total // RANKS) * RANKS


def phase_lp_kernels(ledger: Ledger, plan, device, gen) -> None:
    """Compress and decompress at low-precision decentralized's shape: the
    whole model one row per rank, ``(RANKS, lp_row_elements)`` (f32 past
    2^31 bytes), bitwise, and timed per step (1 compress, 3 decompresses)
    under ``other_steps``; then a ragged long row, ``(3, 2^27 + 1)`` (the
    scalar paths)."""
    numel = lp_row_elements(plan)
    x = torch.randn((RANKS, numel), generator=gen, device=device) * 1e-3
    case = f"low-precision decentralized row of {numel} elements"
    q, mm = ledger.compare("compress_minmax_uint8", case, x)
    ledger.compare("decompress_minmax_uint8", case, q, mm)
    step = "low-precision decentralized"
    t = {"compress": ledger.time("compress_minmax_uint8", *codec_cost(RANKS, numel, 6), x, step=step),
         "decompress (x3)": ledger.time("decompress_minmax_uint8", *codec_cost(RANKS, numel, 2), q, mm,
                                        per_step=3, step=step)}
    for name, (ms, plain_ms, bound_ms) in t.items():
        log(f"[kernels] {case} x {RANKS} ranks: {name} {ms:.4f} ms a call, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms")
    del x, q, mm
    torch.cuda.empty_cache()
    x = torch.randn((3, 2**27 + 1), generator=gen, device=device)
    q, mm = ledger.compare("compress_minmax_uint8", "ragged long row (3, 2^27 + 1)", x)
    ledger.compare("decompress_minmax_uint8", "ragged long row (3, 2^27 + 1)", q, mm)
    del x, q, mm
    torch.cuda.empty_cache()


#: the Llama slice: llama_7b_config at its published width, cut to 2 layers
#: and a global batch of 1 sequence of 4096 tokens, zigzag ring over RANKS
LLAMA_LAYERS = 2
LLAMA_BATCH = 1
LLAMA_SEQ = 4096
LLAMA_STEPS = 5
LLAMA_LR = 3e-3


def llama_slice_config() -> LlamaConfig:
    return llama_7b_config(num_layers=LLAMA_LAYERS, sp_axis="intra", sp_layout="zigzag")


def zigzag_pair_masks(sp: int, t2: int, device):
    """The causal masks of the zigzag ring's ``2 sp + 1`` block calls a pass,
    in its order, each ``(sp, t2, t2)`` for the sp members: step 0's pairs
    (0,0), (1,0) and (1,1), then at each later step (1,0) and the call in
    which each member takes its own other live pair.  Member r's queries
    are global half-blocks (r, 2sp-1-r), and at step i it holds the K/V of
    member (r - i) mod sp.  Every row of every call is live; a block wholly
    in the queries' past is all true, expanded over the queries with stride
    0, as the ring passes it."""
    diagonal = torch.ones((t2, t2), dtype=torch.bool, device=device).tril().expand(sp, t2, t2)
    past = torch.ones((sp, 1, t2), dtype=torch.bool, device=device).expand(sp, t2, t2)
    return [diagonal, past, diagonal] + [past, past] * (sp - 1)


def rank_rows(mask: torch.Tensor, reps: int, rows: int) -> torch.Tensor:
    """A per-member mask ``(n, tq, tk)`` over a call's rows: the members
    repeated ``reps`` times (the groups of a mesh whose sp axis is the last)
    and ``rows`` sequences a rank, ``(reps * n * rows, tq, tk)``; a mask
    expanded over the queries keeps its stride 0."""
    past = mask.stride(1) == 0
    per_rank = mask[:, :1] if past else mask
    laid = per_rank.repeat(reps, 1, 1).repeat_interleave(rows, 0).contiguous()
    return laid.expand(-1, *mask.shape[1:]) if past else laid


def attention_inputs(gen, device, b, tq, tk, h, h_kv, d, kv_dtype=torch.float32):
    """Unit-variance q (pre-scaled), k, v and the backward's cotangents."""
    qf = torch.randn((b, tq, h, d), generator=gen, device=device) / d ** 0.5
    k = torch.randn((b, tk, h_kv, d), generator=gen, device=device).to(kv_dtype)
    v = torch.randn((b, tk, h_kv, d), generator=gen, device=device).to(kv_dtype)
    dl = torch.randn((b, h, tq), generator=gen, device=device)
    do = torch.randn((b, h, tq, d), generator=gen, device=device)
    return qf, k, v, dl, do


def check_attention(ledger: Ledger, case: str, qf, k, v, mask, dl, do):
    """The three kernels against their plain versions on one block."""
    _, _, m = ledger.compare("block_attention", case, qf, k, v, mask)
    ledger.compare("flash_attention_bwd_dq", case, qf, k, v, mask, m, dl, do)
    ledger.compare("flash_attention_bwd_dkv", case, qf, k, v, mask, m, dl, do)


def attention_cost(qf, k, mask, d):
    """(bytes, f32 operations) of the forward, dq and dk/dv on one block: each
    live (query, key) pair and head costs 4d, 6d and 8d operations (two,
    three and four products of d multiply-adds); the inputs count once
    where the block has a live pair, the mask (its distinct bytes: a mask
    expanded over the queries is one row a sequence) and the outputs
    always."""
    b, tq, h, _ = qf.shape
    live = int(mask.sum()) * h
    f32 = 4
    q_bytes, kv_bytes = qf.numel() * f32, 2 * k.numel() * k.element_size()
    row_bytes = b * h * tq * f32  # one of l, m, dl
    mask_bytes = mask.shape[0] * mask.shape[2] if mask.stride(1) == 0 else mask.numel()
    read = (q_bytes + kv_bytes) if live else 0
    fwd = (mask_bytes + q_bytes + 2 * row_bytes + read, 4 * d * live)
    dq = (mask_bytes + q_bytes + 2 * row_bytes + (read + q_bytes if live else 0), 6 * d * live)
    dkv = (mask_bytes + kv_bytes + 2 * row_bytes + (read + q_bytes if live else 0), 8 * d * live)
    return fwd, dq, dkv


def sdpa_ms(qf, k, v, mask, do):
    """The library's time for the same attention, a near-equivalent (it
    normalizes and returns no l or m): ``F.scaled_dot_product_attention``,
    forward, and forward + backward less the forward."""
    q_t, k_t, v_t = (x.transpose(1, 2) for x in (qf, k, v))
    kw = dict(attn_mask=mask[:, None], scale=1.0, enable_gqa=qf.shape[2] != k.shape[2])
    fwd = median_ms(lambda: F.scaled_dot_product_attention(q_t, k_t, v_t, **kw))
    leaves = [x.detach().requires_grad_() for x in (q_t, k_t, v_t)]
    both = median_ms(lambda: F.scaled_dot_product_attention(*leaves, **kw).backward(do))
    return fwd, max(both - fwd, 0.0)


def phase_attention_kernels(ledger: Ledger, device) -> None:
    """The three attention kernels against their plain versions (TF32 off)
    at the Llama slice's shapes and at GQA, bf16 K/V, ragged and degenerate
    ones; timed per slice step at its blocks: RANKS ranks folded into the
    batch, half-blocks of LLAMA_SEQ / (2 RANKS) tokens, 32 heads of 128, the
    ring's 2 RANKS + 1 calls a pass (:func:`zigzag_pair_masks`) a layer."""
    cfg = llama_slice_config()
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    t2 = LLAMA_SEQ // (2 * RANKS)
    gen = torch.Generator(device=device).manual_seed(4)
    qf, k, v, dl, do = attention_inputs(gen, device, RANKS * LLAMA_BATCH, t2, t2, h, cfg.num_kv_heads, d)
    # the slice's blocks, by distinct mask, with the calls a step makes of each
    blocks = {}
    for mask in zigzag_pair_masks(RANKS, t2, device):
        key = (mask.stride(1), mask.cpu().numpy().tobytes())
        blocks.setdefault(key, [rank_rows(mask, 1, LLAMA_BATCH), 0])[1] += LLAMA_LAYERS
    with _no_tf32():
        for n, (mask, calls) in enumerate(blocks.values()):
            live = float(mask.float().mean())
            check_attention(ledger, f"slice block {n} (live share {live:.3f})", qf, k, v, mask, dl, do)
            m = fa.block_attention_plain(qf, k, v, mask)[2]
            lib_fwd, lib_bwd = sdpa_ms(qf, k, v, mask, do)
            costs = attention_cost(qf, k, mask, d)
            ledger.time("block_attention", *costs[0], qf, k, v, mask, per_step=calls,
                        library=lambda: lib_fwd)
            for name, cost in zip(("flash_attention_bwd_dq", "flash_attention_bwd_dkv"), costs[1:]):
                # one library backward computes dq, dk and dv together
                ledger.time(name, *cost, qf, k, v, mask, m, dl, do, per_step=calls,
                            library=lambda: lib_bwd)
        log(f"[kernels] attention: {len(blocks)} distinct blocks of the slice's "
            f"{len(zigzag_pair_masks(RANKS, t2, 'cpu'))} per layer")
        full = torch.ones((RANKS, t2, t2), dtype=torch.bool, device=device)
        diag = full.tril()
        # GQA (a K/V head per 4 query heads: 8 at the slice) and bf16 K/V at
        # the slice's widths
        gqa = attention_inputs(gen, device, RANKS, t2, t2, h, h // 4, d)
        for name, mask in (("diagonal", diag), ("full", full)):
            check_attention(ledger, f"GQA h_kv {h // 4}, {name}", *gqa[:3], mask, *gqa[3:])
        bf16 = attention_inputs(gen, device, RANKS, t2, t2, h, h, d, torch.bfloat16)
        check_attention(ledger, "bf16 K/V, diagonal", *bf16[:3], diag, *bf16[3:])
        # ragged lengths and narrow heads; a fully masked block; rows where
        # only the first key survives
        for d_small in (24, 64):
            x = attention_inputs(gen, device, 2, 200, 300, 4, 2, d_small)
            mask = torch.rand((2, 200, 300), generator=gen, device=device) < 0.5
            mask[:, 7] = False
            check_attention(ledger, f"200x300, d {d_small}", *x[:3], mask, *x[3:])
            first = torch.zeros((2, 200, 300), dtype=torch.bool, device=device)
            first[:, :, 0] = True
            check_attention(ledger, f"200x300, d {d_small}, first key only", *x[:3], first, *x[3:])
            check_attention(ledger, f"200x300, d {d_small}, all masked", *x[:3],
                            torch.zeros_like(first), *x[3:])
            keys = (torch.rand((2, 1, 300), generator=gen, device=device) < 0.5).expand(2, 200, 300)
            check_attention(ledger, f"200x300, d {d_small}, a key mask expanded over the queries", *x[:3],
                            keys, *x[3:])
    for name in ATTENTION_TOLS:
        row = ledger.rows[name]
        log(f"[kernels] {name}: {row['checks']} comparisons within {ATTENTION_TOLS[name]} "
            f"(max abs error {row['max_abs_err']:.3e}); per Llama slice step {row['ms']:.4f} ms "
            f"(plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}, SDPA {row['library_ms']:.4f} ms)")


#: path (a), the kernel's path: the sequence-parallel Megatron MLP pair at
#: llama_7b_config's widths (hidden 4096, MLP 11008), one sequence of 4096
#: tokens over SP_MLP_TP tensor-parallel ranks on this one card, f32
SP_MLP_TP = 4
SP_MLP_TOKENS = 4096
SP_MLP_STEPS = 5
SP_MLP_LR = 0.01


def sp_mlp_gemms(hidden: int, inter: int, tp: int, tokens: int):
    """The tile products one step of path (a) makes, by shape: ``name ->
    (m, k, n, transposed operand, launches a step)``, each for all tp
    ranks at once.  Forward: tp ``ag_matmul`` blocks (Column) and tp
    ``matmul_rs`` blocks (Row); backward: the Column's ``dw`` (its input is
    data: no ``dx``) and the Row's ``dx`` and ``dw``, tp each."""
    t, i = tokens // tp, inter // tp
    return {
        "Column fwd (ag_matmul)": (t, hidden, i, None, tp),
        "Column dw = x^T g": (hidden, t, i, "x", tp),
        "Row fwd (matmul_rs)": (t, i, hidden, None, tp),
        "Row dx = g w^T": (t, hidden, i, "w", tp),
        "Row dw = x^T g": (i, t, hidden, "x", tp),
    }


def phase_matmul_kernels(ledger: Ledger, device) -> None:
    """The tile kernel against ``x @ w`` (TF32 off for both) at every
    product of path (a), the backward's through transposed views and the
    Row's inputs through the ring's per-rank block views; at edge shapes;
    on a rank batch with a stride-0 operand.  At each path (a) product the
    plain product of the operands rounded to TF32 must miss the tolerance,
    so it is shown to tell the precisions apart at those K.  Timed per path
    (a) step beside its bound (2 m n k per rank over 67 TFLOP/s) and
    ``torch.matmul`` (the plain version is that call too)."""
    cfg = llama_7b_config()
    tp, gen = SP_MLP_TP, torch.Generator(device=device).manual_seed(6)
    shares, tf32_shares = {}, {}
    with _no_tf32():
        for name, (m, k, n, trans, per_step) in sp_mlp_gemms(
                cfg.hidden_size, cfg.intermediate_size, tp, SP_MLP_TOKENS).items():
            if trans == "x":  # x^T: a (k, m) row-major tensor read transposed
                x = torch.randn((tp, k, m), generator=gen, device=device).transpose(1, 2)
            else:  # a row block of a (tp, tp * m, k) tensor, as the rings slice it
                x = torch.randn((tp, tp, m, k), generator=gen, device=device)[:, 1]
            w = (torch.randn((tp, n, k), generator=gen, device=device).transpose(1, 2)
                 if trans == "w" else torch.randn((tp, k, n), generator=gen, device=device))
            shares[name] = ledger.compare_matmul(name, x, w)
            # the gate separates precisions here: the product of the
            # operands rounded to TF32 must miss it
            tf32_shares[name] = matmul_share(cm.matmul_tile_plain(round_tf32(x), round_tf32(w)),
                                             cm.matmul_tile_plain(x, w), x, w)
            if tf32_shares[name] <= 1.0:
                raise AssertionError(f"matmul_tile's tolerance does not reject TF32 inputs on {name}: "
                                     f"{tf32_shares[name]:.3f} of the bound")
            ms, plain_ms, bound_ms = ledger.time(
                "matmul_tile", 4 * tp * (m * k + k * n + m * n), 2 * tp * m * n * k, x, w,
                per_step=per_step, library=lambda: median_ms(lambda: torch.matmul(x, w)))
            log(f"[kernels] matmul_tile {name}: {tp} x ({m}, {k}) @ ({k}, {n}), {per_step} a step: "
                f"{ms:.4f} ms = {2 * tp * m * n * k / ms / 1e9:.1f} TFLOP/s (torch.matmul {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms); error {shares[name]:.2e} of the bound, "
                f"TF32 inputs {tf32_shares[name]:.2f}")
            del x, w
        for m, k, n in ((9, 7, 10), (1, 1, 1), (16, 32, 48)):
            x = torch.randn((k, m), generator=gen, device=device)
            w = torch.randn((n, k), generator=gen, device=device)
            shares[f"{m}x{k}x{n}"] = ledger.compare_matmul(f"{m}x{k}x{n}", x.t().contiguous(), w.t().contiguous())
            shares[f"{m}x{k}x{n} transposed"] = ledger.compare_matmul(f"{m}x{k}x{n} transposed", x.t(), w.t())
        x = torch.randn((1, 300, 1000), generator=gen, device=device).expand(3, -1, -1)
        w = torch.randn((3, 1000, 130), generator=gen, device=device)
        shares["3 ranks, stride-0 x"] = ledger.compare_matmul("3 ranks, stride-0 x", x, w)
        # the reference's dtype rule: operands that are not both f32 take
        # x @ w (jnp.dot there) and launch nothing
        launches = cm.matmul_tile.launches
        for dtype in (torch.bfloat16, torch.float16, torch.float64):
            xd, wd = x[:, :40, :64].to(dtype), w[:, :64, :56].to(dtype)
            if not same(cm.matmul_tile(xd, wd), xd @ wd):
                raise AssertionError(f"matmul_tile on {dtype} operands is not x @ w")
        if cm.matmul_tile.launches != launches:
            raise AssertionError("matmul_tile launched its f32 kernel for other types")
    row = ledger.rows["matmul_tile"]
    log(f"[kernels] matmul_tile: {row['checks']} comparisons within {matmul_tol(1):.3e} sqrt(K) "
        f"(|x| |w|) (max abs error {row['max_abs_err']:.3e}, at most {max(shares.values()):.2e} of "
        f"the bound; TF32 inputs at least {min(tf32_shares.values()):.2f} of it at path (a)'s shapes); "
        f"per path (a) step {row['ms']:.4f} ms (torch.matmul {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']})")


def phase_rings(device) -> None:
    """The two rings on the card at path (a)'s shapes: ``ag_matmul`` bidir
    bitwise equal to uni (the same block products, no atomics);
    ``matmul_rs`` bidir equal to uni, and both rings equal to ``allgather``
    + ``torch.matmul`` and ``allreduce(SUM)`` + the rank's row block, within
    ``matmul_tol`` of the whole contraction times the ``|x| |w|`` sums."""
    cfg = llama_7b_config()
    tp, gen = SP_MLP_TP, torch.Generator(device=device).manual_seed(7)
    group = BaguaProcessGroup([device] * tp)
    t, i = SP_MLP_TOKENS // tp, cfg.intermediate_size // tp
    rank = torch.arange(tp, device=device)
    with _no_tf32():
        x = torch.randn((tp, t, cfg.hidden_size), generator=gen, device=device)
        w = torch.randn((tp, cfg.hidden_size, i), generator=gen, device=device)
        uni, bidir = (cm.ag_matmul(x, w, group, "intra", ring=r) for r in ("uni", "bidir"))
        if not same(uni, bidir):
            raise AssertionError(f"ag_matmul bidir differs from uni by up to {abs_err(uni, bidir):.3e}")
        want, bound = allgather(x, group) @ w, allgather(x.abs(), group) @ w.abs()
        ag_share = float(((uni - want).abs() / (matmul_tol(cfg.hidden_size) * bound)).max())
        del x, w, uni, bidir, want, bound
        x = torch.randn((tp, SP_MLP_TOKENS, i), generator=gen, device=device)
        w = torch.randn((tp, i, cfg.hidden_size), generator=gen, device=device)
        uni, bidir = (cm.matmul_rs(x, w, group, "intra", ring=r) for r in ("uni", "bidir"))
        blocks = lambda y: y.reshape(tp, tp, t, -1)[rank, rank]  # noqa: E731
        want = blocks(allreduce(x @ w, ReduceOp.SUM, group))
        bound = matmul_tol(tp * i) * blocks(allreduce(x.abs() @ w.abs(), ReduceOp.SUM, group))
        rs_share = max(float(((got - want).abs() / bound).max()) for got in (uni, bidir))
        bidir_share = float(((bidir - uni).abs() / bound).max())
    if max(ag_share, rs_share, bidir_share) > 1.0:
        raise AssertionError(f"rings vs the plain collectives: ag {ag_share:.3e}, rs {rs_share:.3e}, "
                             f"rs bidir vs uni {bidir_share:.3e} of the bound")
    log(f"[rings] tp {tp} at path (a)'s shapes: ag_matmul bidir bitwise equal to uni, within "
        f"{ag_share:.2e} of the bound of allgather + matmul; matmul_rs uni and bidir within "
        f"{rs_share:.2e} of allreduce + slice, bidir within {bidir_share:.2e} of uni")


REF_STEPS, REF_LR = 3, 0.05
REF_VGG = dict(num_classes=10, cfg=(16, "M", 32, "M"), classifier_width=64, image_size=32)
#: the reference phase's algorithms: name -> (algorithm, quantizations one
#: element meets per exchange, levels); 0 quantizations for the f32 wire.
#: ZeRO's reduce-scatter quantizes as the ring's first leg or ByteGrad's
#: scatter stage; its parameter all-gather is exact
REF_ALGORITHMS = {
    "ByteGrad": (ByteGradAlgorithm, 2, 255.0),
    "int8 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int8"), RANKS, 255.0),
    "int4 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int4"), RANKS + 1, 15.0),
    "f32": (GradientAllReduceAlgorithm, 0, None),
    "ZeRO f32": (ZeroAlgorithm, 0, None),
    "ZeRO ByteGrad": (functools.partial(ZeroAlgorithm, compression="bytegrad"), 2, 255.0),
    "ZeRO int8 ring": (functools.partial(ZeroAlgorithm, wire_precision="int8"), RANKS - 1, 255.0),
    "ZeRO int4 ring": (functools.partial(ZeroAlgorithm, wire_precision="int4"), RANKS, 15.0),
}
#: ZeRO runs that must equal an unsharded one on the card bit for bit
ZERO_TWINS = {"ZeRO f32": "f32", "ZeRO ByteGrad": "ByteGrad"}
#: the share of elements that may lie beyond rounding: those a flipped level
#: moved (a flip disturbs at most its own block)
FLIPPED_SHARE = 0.05
#: the f32 wires: each step's averaged gradient differs from the CPU's by at
#: most the gradient noise at equal parameters; the parameters' own
#: differences may grow it over the steps, by this factor at most
F32_GROWTH = 4


def _level_width(name, trainer, state, batch) -> float:
    """The widest quantization level the exchange can meet this step, in
    units of the averaged gradient.  ByteGrad: over each rank's chunks and
    the chunks of their mean.  The ring: every partial sum of a bucket lies
    within plus or minus the sum over ranks of each rank's largest
    |gradient + residual|, divided by the RANKS of the average.  The f32
    wire: 0."""
    levels = REF_ALGORITHMS[name][2]
    if levels is None:
        return 0.0
    state = trainer.ddp.finalize_pending_updates(state)
    _, grads = trainer.ddp._rank_grads(state.params, batch)
    resid = state.algo_state.get("qr_residual") if isinstance(state.algo_state, dict) else None
    width = 0.0
    for i, flat in enumerate(trainer.ddp.plan.bucketize(grads)):
        if name.endswith("ByteGrad"):
            for chunks in (flat.reshape(-1, flat.shape[1] // RANKS), flat.mean(0).reshape(RANKS, -1)):
                width = max(width, float((chunks.amax(1) - chunks.amin(1)).max()) / levels)
            continue
        if resid is not None:
            flat = flat + resid[i]
        width = max(width, 2.0 * float(flat.abs().amax(1).sum()) / levels / RANKS)
    return width


@contextlib.contextmanager
def _no_tf32():
    """f32 convolutions and matmuls on the card, as on the CPU."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms: the same convolution gradients
    from one run to the next."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _small_trainer(name, device, overlap="auto"):
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    return Trainer(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                   lambda ps: torch.optim.SGD(ps, lr=REF_LR), REF_ALGORITHMS[name][0](), group,
                   overlap=overlap)


def _train_small_vgg(name, device, params, batch, overlap="auto"):
    """REF_STEPS steps of the small f32 VGG over RANKS ranks (``intra_size=1``)
    with algorithm ``name`` (overlap as the engine resolves ``overlap``).
    Returns every step's per-rank losses, the final rank-0 parameters, the
    widest quantization level the exchange met and the int4 residuals
    carried into the next step."""
    trainer = _small_trainer(name, device, overlap)
    state = trainer.init_state(tree_map(lambda t: t.to(device), params))
    batch = tuple(t.to(device) for t in batch)
    width, losses = 0.0, []
    for _ in range(REF_STEPS):
        width = max(width, _level_width(name, trainer, state, batch))
        state = trainer.fit(state, [batch], n_steps=1)
        losses.append(trainer.losses.cpu())
    resid = [r.cpu() for r in state.algo_state.get("qr_residual", ())] \
        if isinstance(state.algo_state, dict) else []
    state = trainer.ddp.finalize_pending_updates(state)
    return losses, tree_map(lambda t: t.cpu(), trainer.ddp.params_unstacked(state)), width, resid


def _gradient_noise(device, params, batch) -> float:
    """The largest difference between the card's and the CPU's per-rank
    gradients at the same parameters and data: cuDNN sums the convolutions
    in another order than the CPU."""
    grads = []
    for dev in (device, torch.device("cpu")):
        trainer = _small_trainer("ByteGrad", dev)
        state = trainer.init_state(tree_map(lambda t: t.to(dev), params))
        grads.append(tree_leaves(trainer.ddp._rank_grads(state.params, tuple(t.to(dev) for t in batch))[1]))
    return max(float((g.cpu() - w).abs().max()) for g, w in zip(*grads))


def _within(name, what, got, want, tight, loose):
    """``got`` against ``want``, elementwise: every element within ``loose``
    (the most the flipped levels allow), and all but FLIPPED_SHARE of them
    within ``tight`` (rounding, where no level flipped).  Returns the
    largest difference and how many of how many elements lie beyond
    ``tight``."""
    d = torch.cat([(g.double() - w.double()).abs().flatten() for g, w in zip(got, want)])
    err, beyond = float(d.max()), int((d > tight).sum())
    if not (err <= loose and beyond <= FLIPPED_SHARE * d.numel()):
        raise AssertionError(
            f"{name}: {what} differ from the CPU run by up to {err:.3e} (tolerance {loose:.3e}), "
            f"{beyond} of {d.numel()} by more than {tight:.3e} (at most a share of {FLIPPED_SHARE})")
    return err, f"{beyond} of {d.numel()} beyond {tight:.3e}"


def phase_reference(device) -> None:
    """The slice's output against a reference on a small input: a small f32
    VGG trained on the card (the CUDA kernels) and on the CPU (the plain
    versions) from the same weights and data, once per algorithm.  TF32 is
    off.  ``noise`` is the largest card-vs-CPU difference of a gradient at
    the same parameters.

    - Losses: the first step's (before any exchange) within rtol 1e-5; the
      last step's, on parameters the exchanges made, within rtol 1e-4.
    - Parameters: a gradient that differs by ``noise`` may land one level
      away at each of the k quantizations an element meets (ByteGrad 2:
      compress and requantize; the ring RANKS: the first compress, RANKS - 2
      hops and the all-gather's compress; int4 one more, for the error
      carried over in the residual; ZeRO's reduce-scatter one quantization
      fewer than the ring, none in its exact all-gather).  So every element
      lies within REF_STEPS x REF_LR x k x the widest averaged level; where
      no level flipped, within REF_STEPS x REF_LR x (noise + a thousandth of
      that level), and at most FLIPPED_SHARE of the elements lie beyond.
      The f32 wires (``gradient_allreduce`` and ZeRO's) within REF_STEPS x
      REF_LR x F32_GROWTH x noise, all but FLIPPED_SHARE within REF_STEPS x
      REF_LR x noise.
    - int4 residuals: each element is one quantization's error, within half
      a level in sum space (RANKS averaged levels) on either device, so the
      two lie within one such level; where no level flipped, the residual
      carries the partial sums' noise, at most RANKS x noise a step, plus a
      thousandth of the level.  A residual that is not carried over, not
      fed back or zero fails this.

    Every wire but int4 runs with overlap (the engine's ``"auto"``) on both
    devices; on the card each also runs monolithic (``overlap=False``), and
    the two card runs' losses and parameters must be bitwise equal.  ZeRO's
    f32 and ByteGrad runs must also equal the unsharded f32 and (flat)
    ByteGrad runs on the card bit for bit (ZERO_TWINS).  The whole phase
    runs with cuDNN's deterministic algorithms, and ends with
    :func:`check_obs_inert_on_card`."""
    with _deterministic():
        _reference_vgg(device)
        check_obs_inert_on_card(device)


def _reference_vgg(device) -> None:
    gen = torch.Generator().manual_seed(2)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen))
    with _no_tf32():
        noise = _gradient_noise(device, params, batch)
    log(f"[reference] card vs CPU gradients at the same parameters within {noise:.3e}")
    card = {}

    def equal_runs(a, b):
        return all(same(x, y) for x, y in zip(a[0], b[0])) and \
            all(same(x, y) for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])))

    for name, (_, k, _) in REF_ALGORITHMS.items():
        with _no_tf32():
            got_losses, got, _, got_resid = _train_small_vgg(name, device, params, batch)
            card[name] = (got_losses, got)
            overlap = _small_trainer(name, device).ddp.overlap_enabled
            if overlap:
                mono_losses, mono, _, _ = _train_small_vgg(name, device, params, batch, overlap=False)
                if not equal_runs(card[name], (mono_losses, mono)):
                    raise AssertionError(f"{name}: overlap and monolithic runs on the card differ")
        if name in ZERO_TWINS and not equal_runs(card[name], card[ZERO_TWINS[name]]):
            raise AssertionError(f"{name}: differs on the card from the unsharded {ZERO_TWINS[name]} run")
        want_losses, want, width, want_resid = _train_small_vgg(name, torch.device("cpu"), params, batch)
        for step, rtol in ((0, 1e-5), (REF_STEPS - 1, 1e-4)):
            if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
                raise AssertionError(f"{name}: step {step + 1} losses {got_losses[step].tolist()} "
                                     f"vs CPU {want_losses[step].tolist()}")
        tight = REF_STEPS * REF_LR * (noise + 1e-3 * width)
        loose = REF_STEPS * REF_LR * (k * width if k else F32_GROWTH * noise)
        err, beyond = _within(name, "parameters", tree_leaves(got), tree_leaves(want), tight, loose)
        carry = ""
        if want_resid:
            level = RANKS * width
            if not all(bool(g.abs().max() > 0) for g in got_resid):
                raise AssertionError(f"{name}: a bucket's residual is zero on the card")
            r_max = max(float(g.abs().max()) for g in got_resid)
            r_err, r_beyond = _within(name, "residuals", got_resid, want_resid,
                                     REF_STEPS * RANKS * noise + 1e-3 * level, level)
            carry = (f"; residuals carried over up to {r_max:.3e}, card vs "
                     f"CPU within {r_err:.3e} (level {level:.3e}), {r_beyond}")
        if overlap:
            carry += "; overlap on the card bitwise equal to monolithic"
        if name in ZERO_TWINS:
            carry += f"; bitwise equal on the card to the unsharded {ZERO_TWINS[name]} run"
        log(f"[reference] small VGG, {REF_STEPS} {name} steps{' (overlap)' if overlap else ''}, "
            f"card vs CPU: losses "
            f"{got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
            f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within "
            f"{err:.3e} (tolerance {loose:.3e}), {beyond}{carry}")


#: the slice's paths: name -> (algorithm, launches per step and bucket of
#: each kernel that runs on it; every other kernel must not launch)
SLICE_PATHS = {
    "ByteGrad": (ByteGradAlgorithm, {"compress_minmax_uint8": 1, "decompress_minmax_uint8": 1,
                                     "decompress_reduce_requantize": 1}),
    "int8 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int8"),
                  {"compress_minmax_uint8": 2, "decompress_minmax_uint8": 2,
                   "hop_dequant_add_requant_int8": RANKS - 2}),
    "int4 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int4"),
                  {"compress_minmax_uint4": 2, "decompress_minmax_uint4": 2,
                   "hop_dequant_add_requant_int4": RANKS - 2}),
}


def _union(spans):
    """Sorted, disjoint intervals covering ``spans`` (start, end) pairs."""
    merged = []
    for start, stop in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return merged


def _length(intervals) -> float:
    return sum(stop - start for start, stop in intervals)


def _overlap_length(a, b) -> float:
    """The length of the intersection of two disjoint sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_step(name: str, step, side=None) -> None:
    """Traces one call of ``step`` with ``torch.profiler``: the card's
    kernels by time, its busy time (the union of its activities' intervals)
    and idle share of the wall time.  With ``side``, the stream an overlap
    step's exchange runs on (found in the trace by marker kernels launched
    on it before and after the step; the trace may miss its first kernel,
    so the second is launched after the step and the side stream is
    synchronized before the trace stops): that stream's busy time and the
    part of it during which an activity of another stream (the backward's:
    the main stream and cuDNN's own) also ran."""
    from torch.profiler import ProfilerActivity, profile as trace

    def mark():
        if side is not None:
            with torch.cuda.stream(side):
                torch.cuda._sleep(1)
            side.synchronize()

    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mark()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        mark()
    log(f"[profile] {name}:\n" + prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    # the card's activities, less the device-side spans of the host's
    # record_function labels (the exchange labels, the optimizer's), which
    # cover the gaps between their kernels; the busy time with them counted
    # too is the measure of the idle shares taken before the labels existed
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in e.name]
    labels = [e for e in events if e.is_user_annotation]
    marker = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" in e.name]
    events = [e for e in events if not e.is_user_annotation]
    busy = _length(_union((e.time_range.start, e.time_range.end) for e in events)) / 1e3
    busy_labels = _length(_union((e.time_range.start, e.time_range.end) for e in events + labels)) / 1e3
    log(f"[profile] {name}, one traced step: {wall_ms:.1f} ms wall, card busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.3f} (with the labels' device ranges as busy: "
        f"{1 - busy_labels / wall_ms:.3f}); streams {sorted({e.device_resource_id for e in events})}")
    if side is None:
        return
    streams = {e.device_resource_id for e in marker}
    if len(streams) != 1:
        log(f"[profile] {name}: {len(marker)} marker kernels on streams {sorted(streams)} in the trace, "
            "want 1 or 2 on one stream; the exchange's stream not measured")
        return
    stream, = streams
    log(f"[profile] {name}: {len(marker)} of 2 marker kernels in the trace")
    exchange = _union((e.time_range.start, e.time_range.end) for e in events if e.device_resource_id == stream)
    others = _union((e.time_range.start, e.time_range.end) for e in events if e.device_resource_id != stream)
    side_ms, hidden_ms = _length(exchange) / 1e3, _overlap_length(exchange, others) / 1e3
    log(f"[profile] {name}: the exchange's stream {stream} busy {side_ms:.1f} ms, of which "
        f"{hidden_ms:.1f} ms ({hidden_ms / max(side_ms, 1e-9):.3f}) while another stream ran; the "
        f"other streams busy {_length(others) / 1e3:.1f} ms")


def phase_slice(device, profile: bool, name: str):
    """STEPS steps of full-width VGG16 with the path ``name``; returns the
    launch counts of this run."""
    algorithm, per_bucket = SLICE_PATHS[name]
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gen = torch.Generator(device=device).manual_seed(0)
    model, params = init_vgg16(gen, image_size=IMAGE_SIZE, num_classes=NUM_CLASSES,
                               compute_dtype=torch.bfloat16, device=device)
    trainer = Trainer(
        vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        algorithm(), group, overlap=False,
    )
    state = trainer.init_state(params)
    del params
    plan = trainer.ddp.plan
    n = RANKS * BATCH_PER_RANK
    x = torch.rand((n, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device)
    y = torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device)
    batches = itertools.repeat((x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = trainer.fit(state, batches, n_steps=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = trainer.fit(state, batches, n_steps=STEPS - 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    losses = trainer.losses
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{name}: non-finite loss {losses.tolist()}")
    for leaf in tree_leaves(state.params):
        if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
            raise AssertionError(f"{name}: ranks' parameters differ after the steps")
    want = {kernel: STEPS * plan.num_buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, want {want}")
    step_s = (t2 - t1) / (STEPS - 1)
    log(f"[slice] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {name}, "
        f"{plan.num_buckets} buckets: first step {t1 - t0:.3f} s, then {step_s * 1e3:.1f} ms/step "
        f"= {BATCH_PER_RANK / step_s:.1f} img/s per rank, {n / step_s:.1f} img/s on the card; "
        f"loss {losses.tolist()}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches}")
    if profile:
        profile_step(name, lambda: trainer.fit(state, batches, n_steps=1))
    return launches


#: the overlap paths, through the synthetic benchmark's twin: name ->
#: (algorithm name, its arguments, launches per step and bucket)
OVERLAP_PATHS = {
    "ByteGrad": ("bytegrad", {}, SLICE_PATHS["ByteGrad"][1]),
    "int8 ring": ("gradient_allreduce", {"wire_precision": "int8"}, SLICE_PATHS["int8 ring"][1]),
    "f32 tuple": ("gradient_allreduce", {"fuse": "tuple"}, {}),
}


def phase_overlap(device, profile: bool, name: str) -> dict:
    """STEPS steps of full-width VGG16 through the synthetic benchmark's
    twin (``sb.run``: 1 warm-up step, STEPS - 1 timed) with the wire
    ``name``, monolithic and then with overlap, each from the same weights.
    Checks finite losses, the ranks' parameters bitwise equal, the launch
    counts (STEPS x buckets x per bucket) and, with overlap, that every
    bucket was exchanged once a step in ``backward_order()``.  Returns the
    two runs' summed launch counts."""
    algorithm, kwargs, per_bucket = OVERLAP_PATHS[name]
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    total, times = {}, {}
    for overlap in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        model, params = sb.build("vgg16", torch.bfloat16, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        result = sb.run(model, params, group, algorithm, kwargs, batch_size=BATCH_PER_RANK,
                        num_iters=STEPS - 1, num_warmup=1, overlap=overlap)
        launches = read_launches()
        del params
        ddp, what = result.ddp, f"{name} ({'overlap' if overlap else 'monolithic'})"
        if ddp.overlap_enabled is not overlap:
            raise AssertionError(f"{what}: the engine resolved overlap={ddp.overlap_enabled}")
        if not torch.isfinite(result.losses).all():
            raise AssertionError(f"{what}: non-finite loss {result.losses.tolist()}")
        for leaf in tree_leaves(result.state.params):
            if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
                raise AssertionError(f"{what}: ranks' parameters differ after the steps")
        buckets = ddp.plan.num_buckets
        want = {kernel: STEPS * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
        if launches != want:
            raise AssertionError(f"{what}: launch counts {launches}, want {want}")
        exchanges = [STEPS if overlap else 0] * buckets
        order = ddp.plan.backward_order() if overlap else []
        if ddp.exchange_counts != exchanges or ddp.exchange_order != order:
            raise AssertionError(f"{what}: exchanges per bucket {ddp.exchange_counts}, want {exchanges}; "
                                 f"last step's order {ddp.exchange_order}, want {order}")
        times[overlap] = (result.step_seconds * 1e3, torch.cuda.max_memory_allocated() / 2**30)
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
        log(f"[overlap] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {what}, {buckets} buckets: "
            f"warm-up step {result.warmup_seconds:.3f} s, then {times[overlap][0]:.1f} ms/step, peak memory "
            f"{times[overlap][1]:.1f} GiB, optimizer state {ddp.optimizer_state_bytes(result.state)} B per "
            f"rank; exchanges per bucket {ddp.exchange_counts} in order {ddp.exchange_order}; "
            f"launches {launches}")
        if profile:
            profile_step(what, lambda: ddp.train_step(result.state, result.batch), ddp.side_stream)
        del result, ddp, model
    log(f"[overlap] {name}: overlap {times[True][0]:.1f} ms/step against monolithic {times[False][0]:.1f} "
        f"(ratio {times[True][0] / times[False][0]:.3f}); peak memory {times[True][1]:.1f} against "
        f"{times[False][1]:.1f} GiB")
    return total


#: ZeRO through the synthetic benchmark's twin: name -> (ZeroAlgorithm's
#: arguments, overlap, launches per step and bucket).  The reduce-scatter
#: legs only: ByteGrad decompresses its own chunk, the ring runs its first
#: compress, RANKS - 2 hops and one decompress; the parameter all-gather
#: launches nothing
ZERO_PATHS = {
    "ZeRO f32": ({}, True, {}),
    "ZeRO ByteGrad": ({"compression": "bytegrad"}, True, SLICE_PATHS["ByteGrad"][1]),
    "ZeRO int8 ring": ({"wire_precision": "int8"}, True,
                       {"compress_minmax_uint8": 1, "decompress_minmax_uint8": 1,
                        "hop_dequant_add_requant_int8": RANKS - 2}),
    "ZeRO ByteGrad (monolithic)": ({"compression": "bytegrad"}, False, SLICE_PATHS["ByteGrad"][1]),
    "ZeRO int4 ring (monolithic)": ({"wire_precision": "int4"}, False,
                                    {"compress_minmax_uint4": 1, "decompress_minmax_uint4": 1,
                                     "hop_dequant_add_requant_int4": RANKS - 2}),
}


def phase_zero(device, profile: bool, name: str) -> dict:
    """STEPS steps of full-width VGG16 under ZeRO through the synthetic
    benchmark's twin (``sb.run(..., "zero", ...)``: 1 warm-up step, STEPS -
    1 timed) on the path ``name``.  Checks finite losses, the ranks'
    parameters bitwise equal after the last gather, the launch counts, the
    census (with overlap, each bucket once a step in ``backward_order()``)
    and the optimizer state per rank (SGD momentum over each rank's shards:
    4 bytes an element of the padded buckets over RANKS).  Returns the
    launch counts."""
    kwargs, overlap, per_bucket = ZERO_PATHS[name]
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gc.collect()
    torch.cuda.empty_cache()
    model, params = sb.build("vgg16", torch.bfloat16, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = sb.run(model, params, group, "zero", kwargs, batch_size=BATCH_PER_RANK,
                    num_iters=STEPS - 1, num_warmup=1, overlap=overlap)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    ddp = result.ddp
    if ddp.overlap_enabled is not overlap:
        raise AssertionError(f"{name}: the engine resolved overlap={ddp.overlap_enabled}")
    if not torch.isfinite(result.losses).all():
        raise AssertionError(f"{name}: non-finite loss {result.losses.tolist()}")
    state = ddp.finalize_pending_updates(result.state)
    for leaf in tree_leaves(state.params):
        if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
            raise AssertionError(f"{name}: ranks' parameters differ after the last gather")
    buckets = ddp.plan.num_buckets
    want = {kernel: STEPS * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, want {want}")
    exchanges = [STEPS if overlap else 0] * buckets
    order = ddp.plan.backward_order() if overlap else []
    if ddp.exchange_counts != exchanges or ddp.exchange_order != order:
        raise AssertionError(f"{name}: exchanges per bucket {ddp.exchange_counts}, want {exchanges}; "
                             f"last step's order {ddp.exchange_order}, want {order}")
    opt_bytes = ddp.optimizer_state_bytes(state)
    if opt_bytes != 4 * sum(spec.numel for spec in ddp.plan.specs) // RANKS:
        raise AssertionError(f"{name}: optimizer state {opt_bytes} B per rank")
    step_ms = result.step_seconds * 1e3
    log(f"[zero] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {name}, {buckets} buckets: warm-up "
        f"step {result.warmup_seconds:.3f} s, then {step_ms:.1f} ms/step = "
        f"{BATCH_PER_RANK / result.step_seconds:.1f} img/s per rank, "
        f"{RANKS * BATCH_PER_RANK / result.step_seconds:.1f} img/s on the card; loss "
        f"{result.losses.tolist()}; peak memory {peak:.1f} GiB; optimizer state {opt_bytes} B per rank "
        f"(shard rows {sum(r.numel() * r.element_size() for r in state.optimizer.rows) // RANKS} B); "
        f"exchanges per bucket {ddp.exchange_counts} in order {ddp.exchange_order}; launches {launches}")
    if profile:
        profile_step(name, lambda: ddp.train_step(state, result.batch), ddp.side_stream)
    return launches


#: QAdam on the small VGG: the twin's lr, the compression phase from step 2
#: on, and eps 1e-3, not the default 1e-8.  After a warmup this short the
#: second moment has seen one gradient (the moments update on the first
#: warmup step only): a weight whose gradient was zero or tiny then steps
#: by m / (bc1 (sqrt(v) + eps)) once it gets a larger one.  At 1e-8 the
#: loss runs away within 6 steps in both packages
#: (tests/test_torch_q_adam.py::test_short_warmup_runs_away_at_the_default_eps)
QADAM = dict(lr=1e-3, warmup_steps=2, eps=1e-3)
#: QAdam at full width: full-width VGG16's loss is NaN by its sixth step at
#: the twin's lr (1e-3) and eps 1e-8, and 1.8e16 at eps 1e-3, so lr 1e-5.
#: The step's work does not depend on the values
QADAM_FULL = dict(QADAM, lr=1e-5)
#: the decentralized pair and QAdam on the small VGG: name -> (algorithm
#: factory, steps); QAdam crosses its warmup -> compression switch
REF_DP = {
    "decentralized all": (functools.partial(DecentralizedAlgorithm, peer_selection_mode="all"), REF_STEPS),
    "decentralized shift_one": (functools.partial(DecentralizedAlgorithm, peer_selection_mode="shift_one"),
                                REF_STEPS),
    "low-precision decentralized": (LowPrecisionDecentralizedAlgorithm, REF_STEPS),
    "QAdam": (lambda: QAdamAlgorithm(QAdamOptimizer(**QADAM)), 5),
}
#: small buckets, so that the small VGG's overlap runs have several
REF_DP_BUCKET = 1 << 16
#: low-precision decentralized with overlap against monolithic: every
#: element of every replica quantizes otherwise (per-bucket min/max), and
#: the trajectories part through the gradients; the JAX package's bound
#: for this pair (tests/test_overlap_compressed.py:148-151)
LP_OVERLAP_TOL = 2e-2


def _train_small_dp(name, device, params, batch, overlap):
    """The small f32 VGG over RANKS ranks (``intra_size=1``) with the
    algorithm ``name`` of REF_DP: every step's per-rank losses, every
    rank's final parameters and, for low-precision decentralized, the
    widest level of the weight differences it compressed (the range of
    each rank's replica update over 255)."""
    factory, steps = REF_DP[name]
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    optimizer = None if name == "QAdam" else (lambda ps: torch.optim.SGD(ps, lr=REF_LR))
    ddp = DistributedDataParallel(vgg_loss_fn(VGG(device=device, **REF_VGG)), optimizer, factory(), group,
                                  bucket_size_bytes=REF_DP_BUCKET, overlap=overlap)
    state = ddp.init(tree_map(lambda t: t.to(device), params))
    batch = tuple(t.to(device) for t in batch)
    losses, width = [], 0.0
    for _ in range(steps):
        before = list(state.algo_state["weight"]) if isinstance(state.algo_state, dict) and \
            "weight" in state.algo_state else []
        state, step_losses = ddp.train_step(state, batch)
        losses.append(step_losses.cpu())
        for new, old in zip(state.algo_state["weight"] if before else [], before):
            d = new - old
            width = max(width, float((d.amax(1) - d.amin(1)).max()) / 255.0)
    return losses, [t.cpu() for t in tree_leaves(state.params)], width, ddp


def phase_reference_dp(device) -> None:
    """Decentralized SGD (``all`` and ``shift_one``), low-precision
    decentralized and QAdam on the small f32 VGG, on the card and on the
    CPU (plain versions) from the same weights and data, every rank's
    parameters held together (decentralized leaves the ranks apart):

    - decentralized: f32 rounding only, as the f32 wire's bound:
      REF_STEPS x REF_LR x F32_GROWTH x noise, all but FLIPPED_SHARE within
      REF_STEPS x REF_LR x noise;
    - low-precision decentralized: a difference one rounding away may land
      one level away at each replica's update, carried into the next step:
      REF_STEPS x (3 levels + REF_LR x F32_GROWTH x noise), all but
      FLIPPED_SHARE within REF_STEPS x (REF_LR x noise + a thousandth of a
      level), the level the widest of either run;
    - QAdam: each step moves a parameter by about lr (Adam's normalized
      step), the momentum quantized: within 5 x lr, all but FLIPPED_SHARE
      within a thousandth of that.

    On the card each runs monolithic and with overlap (small buckets, so
    several): decentralized's and QAdam's overlap runs equal their
    monolithic runs bit for bit (cuDNN deterministic); low-precision
    decentralized's per-bucket min/max is another quantization, within
    LP_OVERLAP_TOL of the monolithic run and not equal to it."""
    gen = torch.Generator().manual_seed(2)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen))
    with _no_tf32():
        noise = _gradient_noise(device, params, batch)
    with _deterministic(), _no_tf32():
        for name, (_, steps) in REF_DP.items():
            got_losses, got, width, ddp = _train_small_dp(name, device, params, batch, overlap=False)
            ov_losses, ov, ov_width, ov_ddp = _train_small_dp(name, device, params, batch, overlap=True)
            want_losses, want, want_width, _ = _train_small_dp(name, torch.device("cpu"), params, batch, False)
            if not ov_ddp.overlap_enabled or ov_ddp.plan.num_buckets < 2:
                raise AssertionError(f"{name}: the overlap run has {ov_ddp.plan.num_buckets} buckets")
            width = max(width, ov_width, want_width)
            lr = QADAM["lr"] if name == "QAdam" else REF_LR
            if name == "QAdam":
                loose, tight = steps * lr, steps * lr * 1e-3
            elif name.startswith("low-precision"):
                loose = steps * (3 * width + lr * F32_GROWTH * noise)
                tight = steps * (lr * noise + 1e-3 * width)
            else:
                loose, tight = steps * lr * F32_GROWTH * noise, steps * lr * noise
            for step, rtol in ((0, 1e-5), (steps - 1, 1e-4 if name != "QAdam" else 1e-3)):
                if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
                    raise AssertionError(f"{name}: step {step + 1} losses {got_losses[step].tolist()} "
                                         f"vs CPU {want_losses[step].tolist()}")
            err, beyond = _within(name, "parameters", got, want, tight, loose)
            if name.startswith("low-precision"):
                ov_err = max(abs_err(a, b) for a, b in zip(ov, got))
                if all(same(a, b) for a, b in zip(ov, got)) or not all(
                        torch.allclose(a, b, rtol=LP_OVERLAP_TOL, atol=LP_OVERLAP_TOL) for a, b in zip(ov, got)):
                    raise AssertionError(f"{name}: overlap differs from monolithic by {ov_err:.3e}; want "
                                         f"within rtol and atol {LP_OVERLAP_TOL} and not bit for bit")
                mode = (f"overlap ({ov_ddp.plan.num_buckets} buckets) within {ov_err:.3e} of monolithic "
                        f"(tolerance {LP_OVERLAP_TOL}), level {width:.3e}")
            else:
                if not (all(same(a, b) for a, b in zip(ov, got)) and
                        all(same(a, b) for a, b in zip(ov_losses, got_losses))):
                    raise AssertionError(f"{name}: overlap and monolithic runs on the card differ")
                mode = f"overlap ({ov_ddp.plan.num_buckets} buckets) bitwise equal to monolithic"
            log(f"[reference] small VGG, {steps} {name} steps, card vs CPU: losses "
                f"{got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
                f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within "
                f"{err:.3e} (tolerance {loose:.3e}), {beyond}; {mode}")


def algo_state_bytes(state) -> int:
    """Bytes of algorithm state one rank holds: the distinct tensors of the
    state over the ranks (they are rank-stacked)."""
    seen = {}
    for t in tree_leaves(state.algo_state):
        if torch.is_tensor(t):
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values()) // RANKS


#: the decentralized pair and QAdam through the synthetic benchmark's twin:
#: name -> (algorithm, its arguments, overlap, launches per step and bucket
#: of each kernel on the steps that run it).  Low-precision decentralized
#: compresses its bucket's (RANKS, numel) difference once and decompresses
#: three times a step; QAdam runs ByteGrad's pipeline on its compression
#: steps only (every step from QADAM_FULL's warmup on)
DP_STEPS = 6
LP_PER_BUCKET = {"compress_minmax_uint8": 1, "decompress_minmax_uint8": 3}
DP_PATHS = {
    "decentralized shift_one": ("decentralized", {"peer_selection_mode": "shift_one"}, False, {}),
    "decentralized shift_one (overlap)": ("decentralized", {"peer_selection_mode": "shift_one"}, True, {}),
    "decentralized all": ("decentralized", {"peer_selection_mode": "all"}, False, {}),
    "low-precision decentralized": ("low_precision_decentralized", {}, False, LP_PER_BUCKET),
    "low-precision decentralized (overlap)": ("low_precision_decentralized", {}, True, LP_PER_BUCKET),
    "QAdam": ("qadam", {}, False, SLICE_PATHS["ByteGrad"][1]),
    "QAdam (overlap)": ("qadam", {}, True, SLICE_PATHS["ByteGrad"][1]),
}


def phase_dp(device, profile: bool, name: str) -> dict:
    """DP_STEPS steps of full-width VGG16 through the synthetic benchmark's
    twin (1 warm-up step, DP_STEPS - 1 timed) with the path ``name`` of
    DP_PATHS; QAdam with ``QAdamOptimizer(**QADAM_FULL)``.  Checks finite
    losses, the launch counts (per bucket, on every step or on QAdam's
    compression steps), the census (overlap in the weight and gradient
    modes: each bucket once a step in
    ``backward_order()``; low precision's post-step mode issues nothing
    from the backward) and, for the centralized QAdam, the ranks'
    parameters bitwise equal.  Prints ms/step, img/s per rank, the peak
    memory and the algorithm's state per rank; returns the launch counts."""
    algorithm, kwargs, overlap, per_bucket = DP_PATHS[name]
    if algorithm == "qadam":
        kwargs = {"q_adam_optimizer": QAdamOptimizer(**QADAM_FULL)}
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gc.collect()
    torch.cuda.empty_cache()
    model, params = sb.build("vgg16", torch.bfloat16, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = sb.run(model, params, group, algorithm, kwargs, batch_size=BATCH_PER_RANK,
                    num_iters=DP_STEPS - 1, num_warmup=1, overlap=overlap)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    ddp = result.ddp
    if ddp.overlap_enabled is not overlap:
        raise AssertionError(f"{name}: the engine resolved overlap={ddp.overlap_enabled}")
    if not torch.isfinite(result.losses).all():
        raise AssertionError(f"{name}: non-finite loss {result.losses.tolist()}")
    if algorithm == "qadam":
        for leaf in tree_leaves(result.state.params):
            if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
                raise AssertionError(f"{name}: ranks' parameters differ after the steps")
    buckets = ddp.plan.num_buckets
    steps = DP_STEPS - QADAM_FULL["warmup_steps"] if algorithm == "qadam" else DP_STEPS
    want = {kernel: steps * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, want {want}")
    if algorithm == "low_precision_decentralized":
        # the kernels phase held the codec at these rows
        kernels_plan = vgg16_plan()
        checked = [n for n, _ in slice_shapes(kernels_plan)] if overlap else [lp_row_elements(kernels_plan)]
        if [spec.numel for spec in ddp.plan.specs] != checked:
            raise AssertionError(f"{name}: buckets of {[spec.numel for spec in ddp.plan.specs]} elements, "
                                 f"the kernels phase checked rows of {checked}")
    hooked = overlap and algorithm != "low_precision_decentralized"
    exchanges = [DP_STEPS if hooked else 0] * buckets
    order = ddp.plan.backward_order() if hooked else []
    if ddp.exchange_counts != exchanges or ddp.exchange_order != order:
        raise AssertionError(f"{name}: exchanges per bucket {ddp.exchange_counts}, want {exchanges}; "
                             f"last step's order {ddp.exchange_order}, want {order}")
    step_ms = result.step_seconds * 1e3
    log(f"[dp] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {name}, {buckets} bucket(s): warm-up "
        f"step {result.warmup_seconds:.3f} s, then {step_ms:.1f} ms/step = "
        f"{BATCH_PER_RANK / result.step_seconds:.1f} img/s per rank, "
        f"{RANKS * BATCH_PER_RANK / result.step_seconds:.1f} img/s on the card; loss "
        f"{result.losses.tolist()}; peak memory {peak:.1f} GiB; algorithm state "
        f"{algo_state_bytes(result.state)} B per rank, optimizer state "
        f"{ddp.optimizer_state_bytes(result.state)} B per rank; exchanges per bucket "
        f"{ddp.exchange_counts}; launches {launches}")
    if profile:
        profile_step(name, lambda: ddp.train_step(result.state, result.batch), ddp.side_stream if hooked else None)
    return launches


def phase_mnist(device) -> dict:
    """The MNIST twin (``examples/mnist.py``) on the card, 3 steps over
    RANKS ranks with ``gradient_allreduce`` and Adam, then with ``"none"``:
    finite losses, no kernel launched.  Returns the launch counts."""
    reset_launches()
    for algorithm in ("gradient_allreduce", "none"):
        t0 = time.perf_counter()
        loss, acc = mnist.main(["--algorithm", algorithm, "--ranks", str(RANKS), "--steps", "3",
                                "--epochs", "1", "--batch-size", "256"])
        if not math.isfinite(loss):
            raise AssertionError(f"MNIST twin, {algorithm}: non-finite loss {loss}")
        log(f"[mnist] {algorithm}, {RANKS} ranks, 3 steps: loss {loss:.4f}, train accuracy {acc:.3f}, "
            f"{time.perf_counter() - t0:.1f} s with the data and the evaluation")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"MNIST twin: launch counts {launches}, want none")
    return launches


# ---------------------------------------------------------------------------
# The sync <-> async relaxations: stale-sync, gossip decentralized,
# gradient accumulation, async model average, and switching the algorithm
# of a live run
# ---------------------------------------------------------------------------

#: the rank under the degradation directive on the stale and gossip paths
STALE_RANK = 2
STALE_TAU, GOSSIP_TAU = 2, 1
RELAX_STEPS = 6


def _small_run(device, algorithm, params, batch, steps, overlap=False, before=None, lr=REF_LR):
    """``steps`` SGD steps of the small f32 VGG over RANKS ranks
    (``intra_size=1``, REF_DP_BUCKET buckets) with ``algorithm``;
    ``before(i, state, ddp)`` runs before step i and returns the state it
    takes.  Returns every step's per-rank losses, the final stacked
    parameters (on the CPU, the pending ZeRO update gathered), the
    algorithm state's staleness counters after each step (None without
    them) and the engine."""
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    ddp = DistributedDataParallel(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                                  lambda ps: torch.optim.SGD(ps, lr=lr), algorithm, group,
                                  bucket_size_bytes=REF_DP_BUCKET, overlap=overlap)
    state = ddp.init(tree_map(lambda t: t.to(device), params))
    batch = tuple(t.to(device) for t in batch)
    losses, counters = [], []
    for i in range(steps):
        if before is not None:
            state = before(i, state, ddp)
        state, step_losses = ddp.train_step(state, batch)
        losses.append(step_losses.cpu())
        if isinstance(state.algo_state, dict) and "staleness" in state.algo_state:
            counters.append(state.algo_state["staleness"].tolist())
    state = ddp.finalize_pending_updates(state)
    return losses, [t.cpu() for t in tree_leaves(state.params)], counters or None, ddp


def _counter(i: int, tau: int) -> int:
    """The staleness counter, after step i, of a rank under the directive
    from step 0: it replays tau rounds, then makes a fresh one."""
    return (i % (tau + 1)) + 1 if i % (tau + 1) < tau else 0


def _flag(ranks):
    """``before``: the degradation directive on ``ranks`` before step 0."""
    return lambda i, state, ddp: ddp.apply_degradation_directive(state, ranks) if i == 0 else state


def _switching(plan):
    """``before``: ``ddp.switch_algorithm`` to ``plan[i]`` before step i."""
    return lambda i, state, ddp: ddp.switch_algorithm(state, plan[i], reason="manual") if i in plan else state


def _runs_equal(a, b) -> bool:
    return all(same(x, y) for x, y in zip(a[0], b[0])) and all(same(x, y) for x, y in zip(a[1], b[1]))


def phase_reference_relax(device) -> None:
    """The relaxations on the small f32 VGG, on the card against the CPU
    (plain versions) from the same weights and data, cuDNN deterministic,
    TF32 off; RELAX_STEPS steps, rank STALE_RANK under the directive:

    - stale-sync (τ STALE_TAU) and gossip decentralized (``all`` and
      ``shift_one``, τ GOSSIP_TAU): parameters within the f32 wire's bound
      of the CPU run's (RELAX_STEPS x REF_LR x F32_GROWTH x noise, all but
      FLIPPED_SHARE within RELAX_STEPS x REF_LR x noise), the staleness
      counters equal; on the card the overlap run (stale: post-step; gossip:
      the weight mode, several buckets) bitwise equal to the monolithic
      one, and τ=0 bitwise equal to ``gradient_allreduce`` (stale) and to
      τ=None (gossip);
    - the switch ``gradient_allreduce`` -> ``zero`` after 3 steps: bitwise
      equal on the card to a run that stayed on ``gradient_allreduce``, and
      within the f32 bound of the same switch on the CPU."""
    gen = torch.Generator().manual_seed(2)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen))
    cpu = torch.device("cpu")
    with _no_tf32():
        noise = _gradient_noise(device, params, batch)
    loose, tight = RELAX_STEPS * REF_LR * F32_GROWTH * noise, RELAX_STEPS * REF_LR * noise
    cases = {
        "stale": (lambda tau=STALE_TAU: StaleSyncAlgorithm(staleness_tau=tau), GradientAllReduceAlgorithm),
        "gossip all": (lambda tau=GOSSIP_TAU: DecentralizedAlgorithm(hierarchical=False, staleness_tau=tau),
                       lambda: DecentralizedAlgorithm(hierarchical=False)),
        "gossip shift_one": (lambda tau=GOSSIP_TAU: DecentralizedAlgorithm(
            hierarchical=False, peer_selection_mode="shift_one", staleness_tau=tau),
            lambda: DecentralizedAlgorithm(hierarchical=False, peer_selection_mode="shift_one")),
    }
    with _deterministic(), _no_tf32():
        for name, (algo, off) in cases.items():
            flag = _flag((STALE_RANK,))
            got = _small_run(device, algo(), params, batch, RELAX_STEPS, before=flag)
            ov = _small_run(device, algo(), params, batch, RELAX_STEPS, overlap=True, before=flag)
            want = _small_run(cpu, algo(), params, batch, RELAX_STEPS, before=flag)
            if not ov[3].overlap_enabled or (name != "stale" and ov[3].plan.num_buckets < 2):
                raise AssertionError(f"{name}: the overlap run has {ov[3].plan.num_buckets} buckets")
            if not _runs_equal(got, ov) or got[2] != ov[2]:
                raise AssertionError(f"{name}: overlap and monolithic runs on the card differ")
            tau = STALE_TAU if name == "stale" else GOSSIP_TAU
            if got[2] != want[2] or got[2] != [[_counter(i, tau) if r == STALE_RANK else 0 for r in range(RANKS)]
                                               for i in range(RELAX_STEPS)]:
                raise AssertionError(f"{name}: staleness counters {got[2]} on the card, {want[2]} on the CPU")
            zero_tau = _small_run(device, algo(0), params, batch, RELAX_STEPS, before=flag)
            plain = _small_run(device, off(), params, batch, RELAX_STEPS)
            if not _runs_equal(zero_tau, plain):
                raise AssertionError(f"{name}: τ=0 differs on the card from the run without staleness")
            err, beyond = _within(name, "parameters", got[1], want[1], tight, loose)
            log(f"[reference] small VGG, {RELAX_STEPS} {name} steps, rank {STALE_RANK} under the directive, "
                f"card vs CPU: losses {got[0][0].mean():.6f} -> {got[0][-1].mean():.6f} vs "
                f"{want[0][0].mean():.6f} -> {want[0][-1].mean():.6f}; parameters within {err:.3e} "
                f"(tolerance {loose:.3e}), {beyond}; rank {STALE_RANK}'s counters "
                f"{[c[STALE_RANK] for c in got[2]]}; overlap "
                f"({ov[3].plan.num_buckets} buckets) and τ=0 bitwise equal on the card")
        switch = _switching({3: "zero"})
        got = _small_run(device, GradientAllReduceAlgorithm(), params, batch, RELAX_STEPS, overlap="auto",
                         before=switch)
        stay = _small_run(device, GradientAllReduceAlgorithm(), params, batch, RELAX_STEPS, overlap="auto")
        want = _small_run(cpu, GradientAllReduceAlgorithm(), params, batch, RELAX_STEPS, overlap="auto",
                          before=switch)
        if got[3].impl.algo_name != "zero" or not _runs_equal(got, stay):
            raise AssertionError("switch to zero: the continuation differs on the card from the unsharded run")
        err, beyond = _within("switch", "parameters", got[1], want[1], tight, loose)
        log(f"[reference] small VGG, {RELAX_STEPS} steps, gradient_allreduce -> zero after 3: bitwise equal "
            f"on the card to the run that stayed unsharded; card vs CPU within {err:.3e} (tolerance "
            f"{loose:.3e}), {beyond}")


#: the relaxations at full width, through the synthetic benchmark's twin:
#: name -> (algorithm (a registry name, or a factory of an Algorithm), its
#: arguments, overlap, steps, launches per bucket on the steps that
#: exchange).  Stale and gossip run with rank STALE_RANK under the directive
#: from step 0
RELAX_PATHS = {
    "stale τ=2": ("stale", {"staleness_tau": STALE_TAU}, False, RELAX_STEPS, {}),
    "stale τ=2 (overlap)": ("stale", {"staleness_tau": STALE_TAU}, True, RELAX_STEPS, {}),
    "gossip all τ=1": ("decentralized", {"hierarchical": False, "staleness_tau": GOSSIP_TAU}, False,
                       RELAX_STEPS, {}),
    "gossip all τ=1 (overlap)": ("decentralized", {"hierarchical": False, "staleness_tau": GOSSIP_TAU}, True,
                                 RELAX_STEPS, {}),
    "gossip shift_one τ=1": ("decentralized", {"hierarchical": False, "peer_selection_mode": "shift_one",
                                               "staleness_tau": GOSSIP_TAU}, False, RELAX_STEPS, {}),
    "gossip shift_one τ=1 (overlap)": ("decentralized", {"hierarchical": False, "peer_selection_mode": "shift_one",
                                                         "staleness_tau": GOSSIP_TAU}, True, RELAX_STEPS, {}),
    "GradientAccumulation(ByteGrad, every=4)": (
        lambda: GradientAccumulation(ByteGradAlgorithm(), every=4), {}, False, 8, SLICE_PATHS["ByteGrad"][1]),
    "async": ("async", {"sync_interval_ms": 50, "warmup_steps": 2}, False, 12, {}),
    "none": ("none", {}, False, 12, {}),
    "switch gradient_allreduce -> zero -> bytegrad": ("gradient_allreduce", {}, "auto", 9,
                                                      SLICE_PATHS["ByteGrad"][1]),
}
#: GradientAccumulation's boundary steps among its 8, and the switch path's
#: targets by step
ACCUMULATION_BOUNDARIES = (3, 7)
SWITCHES = {3: "zero", 6: "bytegrad"}


def _rank_spread(params) -> float:
    """The largest difference between two ranks' copies of a parameter."""
    return max(float((t.amax(0) - t.amin(0)).abs().max()) for t in tree_leaves(params))


def phase_relax(device, profile: bool, name: str, spread_of_none=None) -> dict:
    """Full-width VGG16 (bf16, batch BATCH_PER_RANK a rank, seed-0 weights)
    over RANKS ranks through the twin with the path ``name`` of
    RELAX_PATHS: the first step a warm-up, the rest timed; the device time
    of every step from CUDA events recorded between the steps (no host
    wait inside the run).  Checks finite losses and the launch counts, and:

    - stale and gossip: rank STALE_RANK's staleness counter after each step
      cycles as τ bounds it (stale τ 2: 1, 2, 0, ...; gossip τ 1: 1, 0,
      ...), every other rank's stays 0; stale's ranks bitwise equal
      (everyone adds the same average); overlap's census (gossip: each
      bucket once a step in ``backward_order()``; stale's post-step mode
      none);
    - GradientAccumulation(ByteGrad, every=4): exactly 2 boundary steps'
      worth of ByteGrad's launches (12 buckets x its per-bucket counts x
      2); the parameters bitwise unchanged and SGD's momentum not even
      created over the first 3 steps; the ranks bitwise equal after;
    - async (``sync_interval_ms`` 50, warmup 2): at least one fold, none
      failed; after ``abort()`` and ``shutdown()`` no averager thread
      alive; the ranks' parameter spread below that of the ``"none"`` run
      from the same weights and data (``spread_of_none``);
    - the switch: ``gradient_allreduce`` (3 steps), ``zero`` (3),
      ``bytegrad`` (3), overlap ``"auto"``: optimizer state per rank
      553,430,176 -> 138,357,544 -> 553,430,176 B (4 bytes a parameter,
      then a shard), the codec launched in
      the ByteGrad leg only, the ranks bitwise equal at each switch and at
      the end.

    Prints ms/step, img/s per rank, the peak memory and the algorithm state
    per rank; returns the launch counts and, for ``"none"``, its spread."""
    algorithm, kwargs, overlap, steps, per_bucket = RELAX_PATHS[name]
    if callable(algorithm):
        algorithm = algorithm()
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gc.collect()
    torch.cuda.empty_cache()
    model, params = sb.build("vgg16", torch.bfloat16, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, seen = [], {}
    stale_path = name.startswith(("stale", "gossip"))

    def on_step(i, state, ddp):
        marks.append(torch.cuda.current_stream(device).record_event(torch.cuda.Event(enable_timing=True)))
        if i > 0 and stale_path:
            seen.setdefault("counters", []).append(state.algo_state["staleness"].clone())
        if stale_path and i == 0:
            return ddp.apply_degradation_directive(state, (STALE_RANK,))
        if name.startswith("GradientAccumulation") and i in (0, ACCUMULATION_BOUNDARIES[0]):
            seen[i] = ([t.clone() for t in tree_leaves(state.params)], len(state.optimizer.state))
        if name.startswith("switch") and i in SWITCHES:
            seen.setdefault("launches", []).append(read_launches())
            synced = ddp.finalize_pending_updates(state)
            seen.setdefault("synced", []).append(all(
                torch.equal(t[0], t[r]) for t in tree_leaves(synced.params) for r in range(1, RANKS)))
            seen.setdefault("bytes", []).append(ddp.optimizer_state_bytes(synced))
            state = ddp.switch_algorithm(synced, SWITCHES[i], reason="manual")
            seen["bytes"].append(ddp.optimizer_state_bytes(state))
            if SWITCHES[i] == "zero":  # SGD momentum over each rank's shards of the padded buckets
                seen["sharded"] = 4 * sum(spec.numel for spec in ddp.plan.specs) // RANKS
        return state

    reset_launches()
    result = sb.run(model, params, group, algorithm, kwargs, batch_size=BATCH_PER_RANK,
                    num_iters=steps - 1, num_warmup=1, overlap=overlap, on_step=on_step)
    marks.append(torch.cuda.current_stream(device).record_event(torch.cuda.Event(enable_timing=True)))
    launches = read_launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    ddp = result.ddp
    state = ddp.finalize_pending_updates(result.state)
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    if not torch.isfinite(result.losses).all():
        raise AssertionError(f"{name}: non-finite loss {result.losses.tolist()}")
    if ddp.overlap_enabled is not bool(overlap):
        raise AssertionError(f"{name}: the engine resolved overlap={ddp.overlap_enabled}")
    buckets = ddp.plan.num_buckets
    exchanging = {"GradientAccumulation(ByteGrad, every=4)": len(ACCUMULATION_BOUNDARIES),
                  "switch gradient_allreduce -> zero -> bytegrad": steps - max(SWITCHES)}.get(name, steps)
    want = {kernel: exchanging * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, want {want}")
    ranks_equal = all(torch.equal(t[0], t[r]) for t in tree_leaves(state.params) for r in range(1, RANKS))
    extra = ""
    if stale_path:
        counters = [c.tolist() for c in seen["counters"]] + [state.algo_state["staleness"].tolist()]
        cycle = [_counter(i, kwargs["staleness_tau"]) for i in range(steps)]
        if [c[STALE_RANK] for c in counters] != cycle or any(
                c[r] for c in counters for r in range(RANKS) if r != STALE_RANK):
            raise AssertionError(f"{name}: staleness counters {counters}, want {cycle} on rank {STALE_RANK}")
        hooked = overlap and name.startswith("gossip")
        census = ([steps if hooked else 0] * buckets, ddp.plan.backward_order() if hooked else [])
        if (ddp.exchange_counts, ddp.exchange_order) != census:
            raise AssertionError(f"{name}: exchanges per bucket {ddp.exchange_counts} in order "
                                 f"{ddp.exchange_order}, want {census}")
        if name.startswith("stale") and not ranks_equal:
            raise AssertionError(f"{name}: ranks' parameters differ")
        extra = f"; rank {STALE_RANK}'s staleness after each step {[c[STALE_RANK] for c in counters]}"
    elif name.startswith("GradientAccumulation"):
        (p0, n0), (p3, n3) = seen[0], seen[ACCUMULATION_BOUNDARIES[0]]
        if not all(torch.equal(a, b) for a, b in zip(p0, p3)) or n0 or n3:
            raise AssertionError(f"{name}: the first 3 steps moved the parameters or made momentum ({n0}, {n3})")
        if not ranks_equal:
            raise AssertionError(f"{name}: ranks' parameters differ after the boundary steps")
        del p0, p3
        bound = [step_ms[i] for i in ACCUMULATION_BOUNDARIES]
        held = [ms for i, ms in enumerate(step_ms) if i and i not in ACCUMULATION_BOUNDARIES]
        extra = (f"; boundary steps {statistics.mean(bound):.1f} ms, the others "
                 f"{statistics.mean(held):.1f} ms (device time between steps)")
    elif name in ("async", "none"):
        impl = ddp.impl
        spread = _rank_spread(state.params)
        if name == "async":
            ddp.abort()
            ddp.shutdown()
            alive = [t for t in threading.enumerate() if t.name == "bagua-async-averager"]
            if impl.folds_applied < 1 or impl.folds_failed or alive:
                raise AssertionError(f"{name}: {impl.folds_applied} folds, {impl.folds_failed} failed, "
                                     f"{len(alive)} averager threads alive after shutdown")
            if not spread < spread_of_none:
                raise AssertionError(f"{name}: ranks' spread {spread:.3e}, not below none's {spread_of_none:.3e}")
            extra = (f"; {impl.folds_applied} folds, {impl.folds_failed} failed, no averager thread alive "
                     f"after abort() and shutdown(); ranks' spread {spread:.3e} against none's "
                     f"{spread_of_none:.3e}")
        else:
            extra = f"; ranks' spread {spread:.3e}"
    elif name.startswith("switch"):
        # SGD momentum: 4 bytes a parameter a rank, unsharded (553,430,176 B
        # for VGG16); ZeRO's shards of the padded buckets (138,357,544 B)
        full = 4 * sum(t[0].numel() for t in tree_leaves(state.params))
        want_bytes = [full, seen["sharded"], seen["sharded"], full]
        if seen["bytes"] != want_bytes or not all(seen["synced"]) or not ranks_equal:
            raise AssertionError(f"{name}: optimizer state per rank {seen['bytes']} B, want {want_bytes}; "
                                 f"ranks equal at the switches {seen['synced']}, at the end {ranks_equal}")
        if any(any(counts.values()) for counts in seen["launches"]):
            raise AssertionError(f"{name}: kernels launched before the ByteGrad leg: {seen['launches']}")
        extra = (f"; optimizer state per rank {seen['bytes'][0]} -> {seen['bytes'][1]} -> {seen['bytes'][-1]} B; "
                 "no codec launch before the ByteGrad leg; ranks bitwise equal at both switches and at the end")
    timed = step_ms[1:]
    ms = statistics.mean(timed)
    log(f"[relax] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {name}, {buckets} bucket(s): warm-up "
        f"step {result.warmup_seconds:.3f} s, then {result.step_seconds * 1e3:.1f} ms/step host clock "
        f"({ms:.1f} device) = {BATCH_PER_RANK / result.step_seconds:.1f} img/s per rank; per step "
        f"{[round(t, 1) for t in timed]} ms; loss {result.losses.tolist()}; peak memory {peak:.1f} GiB; "
        f"algorithm state {algo_state_bytes(state)} B per rank, optimizer state "
        f"{ddp.optimizer_state_bytes(state)} B per rank; launches {launches}{extra}")
    if profile:
        profile_step(name, lambda: ddp.train_step(state, result.batch),
                     ddp.side_stream if overlap and name.startswith("gossip") else None)
    # the spread before the traced step, which moves the parameters again
    return (launches, spread) if name == "none" else launches


REF_LLAMA = LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                        intermediate_size=512, max_position_embeddings=256, sp_axis="intra",
                        sp_layout="zigzag")
REF_LLAMA_BATCH, REF_LLAMA_LR = 2, 0.5


def _train_small_llama(device, params, ids, cfg=REF_LLAMA, layout=(1, 1, RANKS)):
    """REF_STEPS SGD steps of a small Llama on the example's ``(dp, tp, sp)``
    ``layout``, from ``params`` on ``ids`` (global, zigzag-permuted).
    Returns every step's per-rank losses and the final rank-0 parameters,
    on the CPU."""
    axes = lp.mesh_axes(*layout)
    group = BaguaProcessGroup([device] * RANKS, intra_size=axes["intra_size"])
    model = LlamaModel(cfg, group, device=device)
    stacked = lp.replicate(tree_map(lambda t: t.to(device), params), RANKS)
    optimizer = torch.optim.SGD(tree_leaves(stacked), lr=REF_LLAMA_LR)
    loss_fn = llama_loss_fn(model)
    shards = lp.shard_ids(ids, group, device, axes["dp_axis"], axes["sp_axis"])
    losses = [lp.train_step(stacked, optimizer, shards, loss_fn, group, axes["avg_axis"]).cpu()
              for _ in range(REF_STEPS)]
    return losses, tree_map(lambda t: t[0].detach().cpu(), stacked)


def phase_llama_reference(device, cfg=REF_LLAMA, layout=(1, 1, RANKS)) -> None:
    """The Llama slice's output against a reference on a small input: a
    small Llama (hidden 256, 4 heads, 2 K/V heads, 2 layers, vocab 512,
    global sequence 256 over RANKS ranks on the example's ``(dp, tp, sp)``
    ``layout``: zigzag sp 4, or tp 2 x sp 2) trained REF_STEPS SGD steps on
    the card (the CUDA kernels) and on the CPU (the plain versions) from the
    same weights and ids, TF32 off.  SGD, not Adam, so that a gradient off by
    a factor shows in the parameters.

    - Losses: the first step's within rtol 1e-5 (f32 sums in another
      order), the last step's within rtol 1e-4.
    - Parameters: every element within 1e-5 + 1e-4 |value| of the CPU run:
      REF_STEPS steps of REF_LLAMA_LR times gradients that agree to about
      1e-6 (the kernels' and cuBLAS's sums against the CPU's)."""
    gen = torch.Generator().manual_seed(5)
    _, params = init_llama(cfg, gen, device="cpu")
    seq = cfg.max_position_embeddings
    sp = layout[2]
    ids = torch.randint(0, cfg.vocab_size, (REF_LLAMA_BATCH, seq), generator=gen)
    ids = ids[:, zigzag_order(seq, sp)]
    reset_launches()
    with _no_tf32():
        got_losses, got = _train_small_llama(device, params, ids, cfg, layout)
    launches = read_launches()
    want_losses, want = _train_small_llama(torch.device("cpu"), params, ids, cfg, layout)
    calls = REF_STEPS * cfg.num_layers * (2 * sp + 1)
    what = f"small Llama (dp {layout[0]} x tp {layout[1]} x sp {sp})"
    for name in ATTENTION_TOLS:
        if launches[name] != calls:
            raise AssertionError(f"{what}: {name} launched {launches[name]} times, want {calls}")
    for step, rtol in ((0, 1e-5), (REF_STEPS - 1, 1e-4)):
        if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
            raise AssertionError(f"{what}: step {step + 1} losses {got_losses[step].tolist()} "
                                 f"vs CPU {want_losses[step].tolist()}")
    err = 0.0
    for (name, g), w in zip(tree_flatten_with_names(got), tree_leaves(want)):
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{what}: parameter {name} differs from the CPU run by up to "
                                 f"{float((g - w).abs().max()):.3e}")
    moved = max(float((w - p).abs().max()) for w, p in zip(tree_leaves(want), tree_leaves(params)))
    log(f"[reference] {what}, {REF_STEPS} SGD steps over {RANKS} ranks, card vs CPU: "
        f"losses {got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
        f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within "
        f"{err:.3e} (they moved up to {moved:.3e}); {calls} launches of each attention kernel")


#: the tensor-parallel reference's small Llama: REF_LLAMA at tp 2 (tp =
#: inter) x sp 2 (sp = intra)
REF_LLAMA_TP = dataclasses.replace(REF_LLAMA, tp_size=2, tp_axis="inter")
REF_SP_MLP = dict(hidden=64, inter=128, tokens=32)


class SPMLP(torch.nn.Module):
    """Path (a)'s model: ``ColumnParallelDense(gather_input)`` -> GELU (tanh,
    as ``jax.nn.gelu``) -> ``RowParallelDense(scatter_output)``, with
    biases, over the ``intra`` axis of ``group``; tokens arrive and leave
    row-sharded (the sequence-parallel layout)."""

    def __init__(self, hidden, inter, tp, fused, group, device, generator=None):
        super().__init__()
        kw = dict(fused=fused, group=group, device=device, generator=generator)
        self.ColumnParallelDense_0 = ColumnParallelDense(hidden, inter, tp, "intra", gather_input=True, **kw)
        self.RowParallelDense_0 = RowParallelDense(inter // tp, hidden, tp, "intra", scatter_output=True, **kw)

    def forward(self, params, x):
        h = self.ColumnParallelDense_0(params["ColumnParallelDense_0"], x)
        return self.RowParallelDense_0(params["RowParallelDense_0"], gelu(h))


def sp_mlp_setup(hidden, inter, tp, tokens, device):
    """Path (a)'s parameters, per rank (rank r's drawn from seed r, as
    ``tests/test_parallel.py:545-560`` draws them), stacked; each rank's
    row block of a global input and of a target, seeded."""
    trees = []
    for r in range(tp):
        gen = torch.Generator(device=device).manual_seed(r)
        trees.append(module_params(SPMLP(hidden, inter, tp, False, None, device, gen)))
    params = tree_unflatten(trees[0], [torch.stack(leaves) for leaves in zip(*map(tree_leaves, trees))])
    del trees
    gen = torch.Generator(device=device).manual_seed(tp)
    x = torch.randn((tp, tokens // tp, hidden), generator=gen, device=device)
    target = torch.randn((tp, tokens // tp, hidden), generator=gen, device=device)
    return params, x, target


def sp_mlp_step(model, params, x, target, optimizer=None):
    """Each rank's mean squared error against its target rows; the gradient
    of their sum; an SGD step if ``optimizer``.  Returns the per-rank
    losses."""
    losses = ((model(params, x) - target) ** 2).mean(dim=(1, 2))
    losses.sum().backward()
    if optimizer is not None:
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
    return losses.detach()


def _train_sp_mlp(device, params, x, target, fused, steps, lr, widths):
    group = BaguaProcessGroup([device] * SP_MLP_TP)
    model = SPMLP(widths["hidden"], widths["inter"], SP_MLP_TP, fused, group, "meta")
    params = tree_map(lambda t: t.detach().to(device, copy=True).requires_grad_(), params)
    optimizer = torch.optim.SGD(tree_leaves(params), lr=lr)
    x, target = x.to(device), target.to(device)
    losses = [sp_mlp_step(model, params, x, target, optimizer).cpu() for _ in range(steps)]
    return losses, tree_map(lambda t: t.detach().cpu(), params)


def phase_tp_reference(device) -> None:
    """The tensor-parallel slice's outputs against references on small
    inputs, card (the tile kernel) vs CPU (the plain version), TF32 off:
    path (a)'s fused pair at tp 4 (hidden 64, MLP 128, 32 tokens), REF_STEPS
    SGD steps at lr 0.5, losses within rtol 1e-5 / 1e-4 (first / last step)
    and parameters within 1e-5 + 1e-4 |value|; then the small Llama at tp 2
    x sp 2 as :func:`phase_llama_reference` holds it."""
    w = REF_SP_MLP
    params, x, target = sp_mlp_setup(w["hidden"], w["inter"], SP_MLP_TP, w["tokens"], torch.device("cpu"))
    reset_launches()
    with _no_tf32():
        got_losses, got = _train_sp_mlp(device, params, x, target, True, REF_STEPS, 0.5, w)
    launches = read_launches()["matmul_tile"]
    want_losses, want = _train_sp_mlp(torch.device("cpu"), params, x, target, True, REF_STEPS, 0.5, w)
    if launches != REF_STEPS * 5 * SP_MLP_TP:
        raise AssertionError(f"small SP MLP: {launches} matmul_tile launches, want {REF_STEPS * 5 * SP_MLP_TP}")
    for step, rtol in ((0, 1e-5), (REF_STEPS - 1, 1e-4)):
        if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
            raise AssertionError(f"small SP MLP: step {step + 1} losses {got_losses[step].tolist()} "
                                 f"vs CPU {want_losses[step].tolist()}")
    err = 0.0
    for (name, g), wt in zip(tree_flatten_with_names(got), tree_leaves(want)):
        err = max(err, float((g - wt).abs().max()))
        if not torch.allclose(g, wt, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"small SP MLP: parameter {name} differs from the CPU run by up to "
                                 f"{float((g - wt).abs().max()):.3e}")
    moved = max(float((wt - p).abs().max()) for wt, p in zip(tree_leaves(want), tree_leaves(params)))
    log(f"[reference] small fused SP MLP pair, tp {SP_MLP_TP}, {REF_STEPS} SGD steps, card vs CPU: "
        f"losses {got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
        f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within {err:.3e} "
        f"(they moved up to {moved:.3e}); {launches} matmul_tile launches")
    phase_llama_reference(device, REF_LLAMA_TP, (1, 2, 2))


def phase_llama_slice(device, profile: bool, layout=(1, 1, RANKS)) -> dict:
    """LLAMA_STEPS AdamW steps of the Llama slice: llama_7b_config's width, 2
    layers, one sequence of LLAMA_SEQ tokens over RANKS ranks on this one
    card on the example's ``(dp, tp, sp)`` ``layout`` (zigzag sp 4, or tp 2
    x sp 2: tp = inter, sp = intra), f32.  Checks the loss is finite, the
    ranks' parameters are bitwise equal (the tp ranks are replicas of one
    shard, as in JAX) and each kernel's launch count; returns the counts."""
    axes = lp.mesh_axes(*layout)
    tp, sp = layout[1], layout[2]
    cfg = llama_7b_config(num_layers=LLAMA_LAYERS, tp_size=tp, tp_axis=axes["tp_axis"] or "intra",
                          sp_axis=axes["sp_axis"], sp_layout="zigzag")
    group = init_process_group(devices=[device] * RANKS, intra_size=axes["intra_size"])
    gen = torch.Generator(device=device).manual_seed(0)
    model, params = init_llama(cfg, gen, device, group)
    stacked = lp.replicate(params, RANKS)
    del params
    optimizer = lp.make_optimizer(stacked, LLAMA_LR)
    loss_fn = llama_loss_fn(model)
    ids_gen = torch.Generator().manual_seed(0)
    zz = zigzag_order(LLAMA_SEQ, sp)
    batches = [lp.shard_ids(torch.randint(0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ),
                                          generator=ids_gen)[:, zz], group, device,
                            axes["dp_axis"], axes["sp_axis"])
               for _ in range(LLAMA_STEPS + 1)]
    step = functools.partial(lp.train_step, stacked, optimizer, loss_fn=loss_fn, group=group,
                             axis=axes["avg_axis"])
    n_params = sum(p[0].numel() for p in tree_leaves(stacked))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(batches[0])]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for ids in batches[1:LLAMA_STEPS]:
        losses.append(step(ids))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    what = f"Llama (dp {layout[0]} x tp {tp} x sp {sp})"
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite loss {losses.tolist()}")
    for leaf in tree_leaves(stacked):
        if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
            raise AssertionError(f"{what}: ranks' parameters differ after the steps")
    # the zigzag ring's 2 sp + 1 live pairs a pass, each for all ranks at once
    calls = LLAMA_STEPS * LLAMA_LAYERS * (2 * sp + 1)
    want = {kernel: calls if kernel in ATTENTION_TOLS else 0 for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches}, want {want}")
    step_s = (t2 - t1) / (LLAMA_STEPS - 1)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    log(f"[slice] {what} at 7B width ({cfg.hidden_size} hidden, {cfg.num_heads} heads, "
        f"{cfg.intermediate_size} MLP, vocab {cfg.vocab_size}), {LLAMA_LAYERS} layers, "
        f"{n_params} parameters per rank, f32; {LLAMA_BATCH} x {LLAMA_SEQ} tokens over {RANKS} "
        f"ranks: first step {t1 - t0:.3f} s, then {step_s * 1e3:.1f} ms/step = "
        f"{tokens / step_s:.1f} tokens/s on the card; loss {losses[:, 0].tolist()}; peak memory "
        f"{peak_memory()}; launches {launches} ({calls} each expected: {LLAMA_STEPS} steps x "
        f"{LLAMA_LAYERS} layers x {2 * sp + 1} live half-block pairs)")
    if profile:
        profile_step(what, lambda: step(batches[-1]))
    return launches


def _sp_mlp_grads(model, params, x, target):
    """Per-rank losses and parameter gradients of one step, no update."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    losses = sp_mlp_step(model, params, x, target)
    return losses, tree_map(lambda t: t.grad, params)


def phase_sp_mlp_slice(device, profile: bool) -> dict:
    """Path (a): SP_MLP_STEPS SGD steps of the fused sequence-parallel MLP
    pair at llama_7b_config's widths, SP_MLP_TP ranks of SP_MLP_TOKENS /
    SP_MLP_TP tokens each on this one card, f32.  Checks that the first
    step's losses and gradients equal the unfused pair's (all-gather +
    ``torch.matmul``, ``psum``) within 1e-5 relative (losses) and 1e-4 of
    each leaf's largest gradient (f32 sums of up to 11,008 terms in another
    order: typically sqrt(K) 2^-24, 6e-6); the loss is finite; exactly 20
    ``matmul_tile`` launches a step and no other kernel.  Then one forward
    and backward of ``ParallelMLP(fused=True)`` against ``fused=False`` on
    the whole replicated sequence, with its own exact count.  Returns the
    steps' launch counts."""
    cfg, tp = llama_7b_config(), SP_MLP_TP
    hidden, inter = cfg.hidden_size, cfg.intermediate_size
    group = init_process_group(devices=[device] * tp)
    params, x, target = sp_mlp_setup(hidden, inter, tp, SP_MLP_TOKENS, device)
    fused, unfused = (SPMLP(hidden, inter, tp, f, group, "meta") for f in (True, False))
    with _no_tf32():
        want_losses, want_grads = _sp_mlp_grads(unfused, params, x, target)
        reset_launches()
        got_losses, got_grads = _sp_mlp_grads(fused, params, x, target)
    per_step = read_launches()["matmul_tile"]
    if not torch.allclose(got_losses, want_losses, rtol=1e-5, atol=0.0):
        raise AssertionError(f"path (a): fused losses {got_losses.tolist()} vs unfused {want_losses.tolist()}")
    grad_err = 0.0
    for (name, g), wg in zip(tree_flatten_with_names(got_grads), tree_leaves(want_grads)):
        rel = float((g - wg).abs().max() / wg.abs().max())
        grad_err = max(grad_err, rel)
        if rel > 1e-4:
            raise AssertionError(f"path (a): fused gradient {name} differs from unfused by {rel:.3e} "
                                 f"of its largest element")
    del want_grads, got_grads
    log(f"[slice] path (a) first step: fused losses {got_losses.tolist()} vs unfused "
        f"{want_losses.tolist()}; gradients within {grad_err:.3e} of each leaf's largest; "
        f"{per_step} matmul_tile launches")

    params = tree_map(lambda t: t.requires_grad_(), params)
    optimizer = torch.optim.SGD(tree_leaves(params), lr=SP_MLP_LR)
    step = functools.partial(sp_mlp_step, fused, params, x, target, optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _no_tf32():
        t0 = time.perf_counter()
        losses = [step()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses += [step() for _ in range(SP_MLP_STEPS - 1)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = read_launches()
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"path (a): non-finite loss {losses.tolist()}")
    calls = SP_MLP_STEPS * 5 * tp
    want = {kernel: calls if kernel == "matmul_tile" else 0 for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"path (a): launch counts {launches}, want {want}")
    step_s = (t2 - t1) / (SP_MLP_STEPS - 1)
    gemm_tflop = 10 * SP_MLP_TOKENS * hidden * inter / 1e12  # 5 products of 2 T H I
    log(f"[slice] path (a): fused SP MLP pair at 7B width ({hidden} -> {inter} -> {hidden}), tp {tp}, "
        f"{SP_MLP_TOKENS // tp} tokens per rank, f32: first step {t1 - t0:.3f} s, then "
        f"{step_s * 1e3:.1f} ms/step ({gemm_tflop:.3f} TFLOP of tile GEMMs a step, "
        f"{gemm_tflop / step_s:.1f} TFLOP/s end to end); loss {losses.mean(1).tolist()}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches['matmul_tile']} "
        f"({calls} expected: {SP_MLP_STEPS} steps x {5 * tp}: {2 * tp} forward, {tp} Column dw, "
        f"{2 * tp} Row dx and dw)")
    if profile:
        with _no_tf32():
            profile_step("path (a)", step)

    # ParallelMLP: a replicated input; the Row's matmul_rs ring + all-gather
    with _no_tf32():
        mlp_x = allgather(x, group)
        outs = []
        for f in (False, True):
            gen = torch.Generator(device=device).manual_seed(0)
            mlp = ParallelMLP(hidden, inter, hidden, tp, "intra", fused=f, group=group, device=device,
                              generator=gen)
            mlp_params = tree_map(lambda t: t[None].repeat(tp, *([1] * t.dim())).requires_grad_(),
                                  module_params(mlp))
            reset_launches()
            out = mlp(mlp_params, mlp_x)
            (out ** 2).mean().backward()
            torch.cuda.synchronize()
            outs.append((out.detach(), [t.grad for t in tree_leaves(mlp_params)], read_launches()["matmul_tile"]))
            del out, mlp_params
    (y_u, g_u, n_u), (y_f, g_f, n_f) = outs
    y_err = float((y_f - y_u).abs().max() / y_u.abs().max())
    g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_f, g_u))
    if n_u != 0 or n_f != 3 * tp or y_err > 1e-4 or g_err > 1e-4:
        raise AssertionError(f"ParallelMLP fused vs unfused: output {y_err:.3e}, gradients {g_err:.3e} "
                             f"of their largest; launches {n_f} fused (want {3 * tp}), {n_u} unfused")
    log(f"[slice] ParallelMLP({hidden} -> {inter} -> {hidden}, tp {tp}, fused) on {SP_MLP_TOKENS} "
        f"replicated tokens: output within {y_err:.3e}, gradients within {g_err:.3e} of the unfused "
        f"layer's (relative to the largest); {n_f} matmul_tile launches (forward {tp}, backward {2 * tp})")
    return launches


# ---------------------------------------------------------------------------
# PR 13: the user-API collectives and BERT-Large
# ---------------------------------------------------------------------------

COLLECTIVE_RANKS = 8  # the tests' group: 2 nodes of 4


def _collective_inputs():
    """Float and integer stacks ``(8, 24, 3)`` from a seed, on the CPU."""
    gen = torch.Generator().manual_seed(9)
    xf = torch.randn((COLLECTIVE_RANKS, 24, 3), generator=gen)
    xi = torch.randint(-1000, 1000, (COLLECTIVE_RANKS, 24, 3), generator=gen, dtype=torch.int32)
    return xf, xi


def phase_collectives(device) -> None:
    """Every collective of the user API and every ``ReduceOp`` on the card's
    stacked tensors against the same call on the CPU, over 8 ranks (2 x 4):
    bitwise for every op, floats included (each fold is the same
    elementwise IEEE operations in the same order on both), exact for
    integers; ``functional.all_reduce``'s gradient likewise; ``barrier``
    returns only once the card is idle; then the collectives twin
    (``examples/communication_primitives``) on 4 ranks of the card."""
    card = init_process_group([device] * COLLECTIVE_RANKS, intra_size=4)
    cpu = BaguaProcessGroup([torch.device("cpu")] * COLLECTIVE_RANKS, intra_size=4)
    xf, xi = _collective_inputs()
    checks = 0

    def both(what, fn, *args, groups=(card, cpu)):
        nonlocal checks
        got = fn(groups[0], *[a.to(device) for a in args])
        want = fn(groups[1], *args)
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            if not same(g.cpu(), w):
                raise AssertionError(f"[collectives] {what}: the card differs from the CPU "
                                     f"(max abs error {abs_err(g.cpu(), w):.3e})")
        checks += 1

    bitwise_ops = (ReduceOp.BOR, ReduceOp.BAND, ReduceOp.BXOR)
    for op in ReduceOp:
        for x in ((xi,) if op in bitwise_ops else (xf, xi)):
            for axis in (None, "inter", "intra"):
                both(f"allreduce {op.name} {x.dtype} over {axis}", lambda g, t: allreduce(t, op, g, axis), x)
            both(f"hierarchical {op.name} {x.dtype}", lambda g, t: hierarchical_allreduce(t, op, g), x)
            both(f"reduce {op.name} {x.dtype}", lambda g, t: bagua.reduce(t, 2, op, g), x)
    for op in (ReduceOp.SUM, ReduceOp.AVG):
        for axis in (None, "inter", "intra"):
            both(f"reduce_scatter {op.name} over {axis}", lambda g, t: reduce_scatter(t, op, g, axis), xf)
    both("reducescatter", lambda g, t: bagua.reducescatter(t, ReduceOp.SUM, g), xf)
    for x in (xf, xi):
        both(f"broadcast {x.dtype}", lambda g, t: bagua.broadcast(t, 3, g), x)
        both(f"scatter {x.dtype}", lambda g, t: bagua.scatter(t, 1, g), x)
        both(f"gather {x.dtype}", lambda g, t: bagua.gather(t, 5, g), x)
        both(f"allgather {x.dtype}", lambda g, t: bagua.allgather(t, g), x)
        both(f"alltoall {x.dtype}", lambda g, t: bagua.alltoall(t, g), x)
    capacity = 3
    data = torch.randn((COLLECTIVE_RANKS, COLLECTIVE_RANKS, capacity, 2), generator=torch.Generator().manual_seed(10))
    counts = (torch.arange(COLLECTIVE_RANKS)[:, None] + torch.arange(COLLECTIVE_RANKS)) % (capacity + 1)
    both("alltoall_v_inplace", lambda g, t, c: bagua.alltoall_v_inplace(t, c, g), data, counts)
    for axis in ("inter", "intra"):
        n = 2 if axis == "inter" else 4
        both(f"alltoall_v_inplace over {axis}",
             lambda g, t, c: bagua.alltoall_v_inplace(t, c, g, axis), data[:, :n], counts[:, :n])
    sub = (bagua.new_group([4, 5, 6, 7], intra_size=2), BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=2))
    for axis in (None, "inter", "intra"):
        both(f"new_group allreduce SUM over {axis}", lambda g, t: allreduce(t, ReduceOp.SUM, g, axis), xf[4:],
             groups=sub)

    def grad(g, t, op):
        leaf = t.clone().requires_grad_()
        (functional_all_reduce(leaf, op, g) ** 2).sum().backward()
        return leaf.grad

    for op in (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.MAX):
        both(f"functional.all_reduce {op.name} gradient", lambda g, t: grad(g, t, op), xf)
    torch.cuda.synchronize()
    torch.cuda._sleep(BUSY_CYCLES)
    done = torch.cuda.Event()
    done.record()
    bagua.barrier(card)
    if not done.query():
        raise AssertionError("[collectives] barrier returned while the card was busy")
    if bagua.broadcast_object({"step": 3}, src=2) != {"step": 3}:
        raise AssertionError("[collectives] broadcast_object changed the object")
    log(f"[collectives] {checks} collectives and ReduceOps over {COLLECTIVE_RANKS} ranks (2 x 4) "
        "bitwise equal on the card and on the CPU; barrier waited for the card")
    communication_primitives.main(["--ranks", str(RANKS)])


BERT_SEQ = sb.BERT_SEQ
SQUAD_BATCH = 8  # a rank
SQUAD_WARMUP, SQUAD_STEPS = 2, 5
BENCH_BATCH = 32  # a rank, the reference's
BENCH_ALGORITHMS = {"gradient_allreduce": {}, "bytegrad": SLICE_PATHS["ByteGrad"][1]}
#: the BERT-Large encoder under sequence parallelism: 2 layers, SP_BATCH
#: sequences of SP_SEQ tokens over RANKS ranks, key-padding lengths drawn
#: from SP_PAD_SEED in [SP_SEQ / 2, SP_SEQ] (seed 4: 463 and 311, so one
#: rank's block of the second sequence is wholly padded and another's in part)
SP_LAYERS, SP_SEQ, SP_BATCH, SP_PAD_SEED = 2, 512, 2, 4
#: the kernels JSON line's names of the three BERT steps (``other_steps``)
SQUAD_STEP, BENCH_STEP, SP_STEP = ("BERT-Large SQuAD", "BERT-Large MLM benchmark (ByteGrad)",
                                   "BERT-Large encoder sp 4")


def bert_plan(cfg, model_cls=None):
    """A BERT model's ByteGrad plan over RANKS ranks, from its shapes alone:
    the QA model's differs from the MLM model's (its head and no MLM
    transform or decoder)."""
    _, params = init_bert(cfg, None, "meta", model_cls=model_cls)
    group = BaguaProcessGroup([torch.device("cpu")] * RANKS, intra_size=1)
    return ByteGradAlgorithm().reify(group).tensors_to_buckets(params)


def same_plan(a, b) -> bool:
    return [(spec.numel, spec.dtype) for spec in a.specs] == [(spec.numel, spec.dtype) for spec in b.specs]


def bert_sp_inputs(device):
    """``(ids, mask)`` of the sp phase, each rank's block ``(RANKS, SP_BATCH,
    SP_SEQ / RANKS)``, and the key-padding lengths."""
    gen = torch.Generator().manual_seed(SP_PAD_SEED)
    lengths = torch.randint(SP_SEQ // 2, SP_SEQ + 1, (SP_BATCH,), generator=gen)
    ids = torch.randint(0, bert_large_config().vocab_size, (SP_BATCH, SP_SEQ), generator=gen)
    mask = torch.arange(SP_SEQ)[None] < lengths[:, None]
    blocks = lambda x: x.reshape(SP_BATCH, RANKS, -1).transpose(0, 1).contiguous().to(device)  # noqa: E731
    return blocks(ids), blocks(mask), lengths.tolist()


def bert_sp_masks(mask):
    """The ring's block masks in its order: at ring step i rank r holds the
    keys of member (r - i) mod RANKS, ``(RANKS * SP_BATCH, tq, tk)`` each."""
    t = mask.shape[-1]
    return [torch.roll(mask, i, dims=0)[:, :, None, :].expand(RANKS, SP_BATCH, t, t).reshape(-1, t, t)
            .contiguous() for i in range(RANKS)]


def bert_codec_kernels(ledger: Ledger, plan, device, step: str, tag: str) -> None:
    """Rows 1-3 at every chunk shape of ``plan`` (a BERT-Large ByteGrad
    plan), bitwise, and timed per ``step`` with the buckets a step makes of
    each shape; a bf16 bucket's gradients are bf16 values, which the
    kernels read as f32."""
    gen = torch.Generator(device=device).manual_seed(7)
    shapes = {}
    for spec in plan.specs:
        shapes[(spec.numel, spec.dtype)] = shapes.get((spec.numel, spec.dtype), 0) + 1
    for (numel, dtype), per_step in sorted(shapes.items()):
        chunk = numel // RANKS
        x = torch.randn((RANKS, numel), generator=gen, device=device) * 1e-3
        if dtype == "bf16":
            x = x.to(torch.bfloat16).float()
        flat, fused_in, dec_in = pipeline_inputs(x, RANKS)
        rows, case = RANKS * RANKS, f"BERT-Large {dtype} bucket of {numel} elements"
        ledger.compare("compress_minmax_uint8", case, flat)
        ledger.compare("decompress_reduce_requantize", case, *fused_in)
        ledger.compare("decompress_minmax_uint8", case, *dec_in)
        t = [ledger.time("compress_minmax_uint8", *codec_cost(rows, chunk, 6), flat, per_step=per_step,
                         step=step),
             ledger.time("decompress_reduce_requantize", rows * chunk + rows * 8 + RANKS * (chunk + 8),
                         rows * chunk * 3 + RANKS * chunk * 5, *fused_in, per_step=per_step, step=step),
             ledger.time("decompress_minmax_uint8", *codec_cost(rows, chunk, 2), *dec_in, per_step=per_step,
                         step=step)]
        log(f"[{tag}] {case} (x{per_step} a step), chunk {chunk}, bitwise: " + "; ".join(
            f"{n} {ms:.4f} ms, plain {p:.4f}, bound {b:.4f}"
            for n, (ms, p, b) in zip(("compress", "fused reduce", "decompress"), t)))
        del x, flat, fused_in, dec_in
    _log_step_sums(ledger, step, f"{plan.num_buckets} buckets")


def bert_sp_kernels(ledger: Ledger, mask, device) -> None:
    """Rows 6-8 at the sp phase's blocks within ATTENTION_TOLS (f32 q
    pre-scaled, bf16 K/V, head dim 64, each ring step's rotating padding
    ``mask``), timed per sp step (SP_LAYERS layers), beside SDPA on the same
    inputs with K/V cast to f32 beforehand, which it needs."""
    cfg = bert_large_config()
    h, d, t = cfg.num_heads, cfg.hidden_size // cfg.num_heads, mask.shape[-1]
    gen = torch.Generator(device=device).manual_seed(8)
    qf, k, v, dl, do = attention_inputs(gen, device, RANKS * SP_BATCH, t, t, h, h, d, torch.bfloat16)
    k32, v32 = k.float(), v.float()
    with _no_tf32():
        for i, block_mask in enumerate(bert_sp_masks(mask)):
            live = float(block_mask.float().mean())
            check_attention(ledger, f"BERT sp ring step {i} (live share {live:.3f})", qf, k, v, block_mask, dl, do)
            m = fa.block_attention_plain(qf, k, v, block_mask)[2]
            lib_fwd, lib_bwd = sdpa_ms(qf, k32, v32, block_mask, do)
            costs = attention_cost(qf, k, block_mask, d)
            ledger.time("block_attention", *costs[0], qf, k, v, block_mask, per_step=SP_LAYERS,
                        library=lambda: lib_fwd, step=SP_STEP)
            for name, cost in zip(("flash_attention_bwd_dq", "flash_attention_bwd_dkv"), costs[1:]):
                ledger.time(name, *cost, qf, k, v, block_mask, m, dl, do, per_step=SP_LAYERS,
                            library=lambda: lib_bwd, step=SP_STEP)
    _log_step_sums(ledger, SP_STEP, f"{SP_LAYERS} layers x {RANKS} ring steps")


def _log_step_sums(ledger: Ledger, step: str, over: str) -> None:
    for name, row in ledger.other_steps[step].items():
        lib = "" if row["library_ms"] is None else f", SDPA {row['library_ms']:.4f} ms"
        log(f"[kernels] {name} per {step} step over {over} {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms{lib})")


def _bitwise_replicas(what: str, params) -> None:
    for name, leaf in tree_flatten_with_names(params):
        if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, leaf.shape[0])):
            raise AssertionError(f"{what}: ranks' parameter {name} differs after the steps")


def phase_bert_squad(ledger: Ledger, device, profile: bool) -> dict:
    """Rows 1-3 at every chunk shape of the SQuAD plan
    (:func:`bert_codec_kernels`), then the SQuAD twin at full BERT-Large width (bf16 compute, 128 tokens,
    batch SQUAD_BATCH a rank) over RANKS ranks on this card, ``intra_size=1``,
    ByteGrad with overlap, Adam 3e-4, seed-0 weights, synthetic SQuAD:
    SQUAD_WARMUP steps, then SQUAD_STEPS counted and timed.  Checks finite
    losses, the ranks' parameters bitwise equal and exactly one launch of
    each of rows 1-3 per bucket and step, on the plan whose shapes were
    checked; returns the counted launches."""
    plan = bert_plan(squad.squad_config(True, BERT_SEQ), squad.BertForQuestionAnswering)
    bert_codec_kernels(ledger, plan, device, SQUAD_STEP, "bert-squad")
    gc.collect()
    torch.cuda.empty_cache()
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    model, params = init_bert(squad.squad_config(True, BERT_SEQ), torch.Generator(device=device).manual_seed(0),
                              device, model_cls=squad.BertForQuestionAnswering)
    marks = {}

    def on_step(i, state, ddp):
        if i == SQUAD_WARMUP:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()
            reset_launches()
        return state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, state, ddp = squad.run(model, params, group, SQUAD_WARMUP + SQUAD_STEPS, SQUAD_BATCH, BERT_SEQ,
                                   log_every=1, on_step=on_step)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - marks["t0"]) / SQUAD_STEPS
    launches = read_launches()
    del params
    what = "[bert-squad] BERT-Large QA, ByteGrad"
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite loss {losses.tolist()}")
    _bitwise_replicas(what, state.params)
    buckets = ddp.plan.num_buckets
    if not same_plan(ddp.plan, plan):
        raise AssertionError(f"{what}: the run's bucket plan is not the plan whose shapes were checked")
    want = {kernel: SQUAD_STEPS * buckets * SLICE_PATHS["ByteGrad"][1].get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches}, want {want}")
    n_params = sum(p[0].numel() for p in tree_leaves(state.params))
    largest = max(ddp.plan.specs, key=lambda spec: spec.numel)
    samples = SQUAD_BATCH * RANKS
    log(f"{what}: {n_params} parameters a rank, bf16 compute, {RANKS} ranks x batch {SQUAD_BATCH} x "
        f"{BERT_SEQ} tokens, overlap {ddp.overlap_enabled}; {dt * 1e3:.1f} ms/step over {SQUAD_STEPS} steps "
        f"after {SQUAD_WARMUP} = {samples / dt:.1f} samples/s on the card ({samples / dt / RANKS:.1f} a rank); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; optimizer state "
        f"{ddp.optimizer_state_bytes(state)} B a rank; plan {buckets} buckets, the largest {largest.numel} "
        f"elements ({largest.slots[0].name}{f' and {len(largest.slots) - 1} more' if len(largest.slots) > 1 else ''}); "
        f"launches a step "
        f"{ {k: n // SQUAD_STEPS for k, n in launches.items() if n} }; losses {losses.mean(1).tolist()}")
    if profile:
        batch = tuple(torch.from_numpy(a).to(device) for a in squad.synthetic_squad(
            np.random.RandomState(1), samples, BERT_SEQ, model.cfg.vocab_size))
        profile_step("BERT-Large SQuAD (ByteGrad, overlap)", lambda: ddp.train_step(state, batch), ddp.side_stream)
    del state, ddp, model
    return launches


def phase_bert_bench(ledger: Ledger, device, profile: bool, algorithm: str) -> dict:
    """The synthetic benchmark's reference line for ``--model bert-large``
    (bf16, SGD momentum 0.9, batch BENCH_BATCH a rank) over RANKS ranks on
    this card, ``intra_size=1``: 1 warm-up step and STEPS - 1 timed.  For
    ByteGrad, first rows 1-3 at every chunk shape of the MLM model's plan
    (:func:`bert_codec_kernels`), and the run's plan must be that one.
    Checks finite losses, the ranks' parameters bitwise equal and the
    launch counts; returns them."""
    what, plan = f"[bert-bench] {algorithm}", None
    if algorithm == "bytegrad":
        plan = bert_plan(bert_large_config(compute_dtype=torch.bfloat16, max_position_embeddings=BERT_SEQ))
        bert_codec_kernels(ledger, plan, device, BENCH_STEP, "bert-bench")
    gc.collect()
    torch.cuda.empty_cache()
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    model, params = sb.build("bert-large", torch.bfloat16, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = sb.run(model, params, group, algorithm, batch_size=BENCH_BATCH, num_iters=STEPS - 1, num_warmup=1)
    launches = read_launches()
    del params
    if not torch.isfinite(result.losses).all():
        raise AssertionError(f"{what}: non-finite loss {result.losses.tolist()}")
    _bitwise_replicas(what, result.state.params)
    if plan is not None and not same_plan(result.ddp.plan, plan):
        raise AssertionError(f"{what}: the run's bucket plan is not the plan whose shapes were checked")
    buckets = result.ddp.plan.num_buckets
    per_bucket = BENCH_ALGORITHMS[algorithm]
    want = {kernel: STEPS * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches}, want {want}")
    log(f"{what}: {result.line} | {RANKS} ranks on one card, batch {BENCH_BATCH} a rank, {buckets} buckets, "
        f"{result.step_seconds * 1e3:.1f} ms/step, {BENCH_BATCH * RANKS / result.step_seconds:.1f} samples/s on the "
        f"card, warm-up step {result.warmup_seconds:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_step(f"BERT-Large MLM benchmark ({algorithm})",
                     lambda: result.ddp.train_step(result.state, result.batch), result.ddp.side_stream)
    del result, model
    return launches


@contextlib.contextmanager
def _plain_attention():
    """The ring's block calls through the plain versions (on the card)."""
    saved = fa.block_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv
    fa.block_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = (
        fa.block_attention_plain, fa.flash_attention_bwd_dq_plain, fa.flash_attention_bwd_dkv_plain)
    try:
        yield
    finally:
        fa.block_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = saved


@contextlib.contextmanager
def _recorded_attention(records):
    """Each ring attention call of the model appends its inputs, output and
    the gradients of q, k, v and of the output to ``records``."""
    def recording(q, k, v, *args, **kwargs):
        rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(), "mask": kwargs["kv_mask"]}
        for name, t in (("dq", q), ("dk", k), ("dv", v)):
            t.register_hook(lambda g, name=name: rec.__setitem__(name, g))
        out = ring_attention(q, k, v, *args, **kwargs)
        out.register_hook(lambda g: rec.__setitem__("dout", g))
        rec["out"] = out.detach()
        records.append(rec)
        return out

    bert_model.ring_attention = recording
    try:
        yield
    finally:
        bert_model.ring_attention = ring_attention


def _share_of_bound(got: torch.Tensor, want: torch.Tensor, tol: float, ulps: float, scale=None) -> float:
    """The largest share of its bound that an element of ``got - want``
    uses: ``tol * max(1, |want|)`` (ATTENTION_TOLS) plus ``ulps`` bf16 ulps
    (2^-7 of a value each) of the element's value or, for a bf16 sum whose
    terms may cancel, of ``scale``, the sum of the terms' magnitudes."""
    g, w = got.double(), want.double()
    scale = w.abs() if scale is None else scale.double()
    bound = tol * w.abs().clamp(min=1.0) + ulps * 2.0 ** -7 * scale
    return float(((g - w).abs() / bound).max())


def _abs_dkv(*args):
    """The plain dk/dv kernel's magnitudes: run through the ring's backward,
    each K/V block's gradient sums the magnitudes of its terms."""
    dk, dv = fa.flash_attention_bwd_dkv_plain(*args)
    return dk.abs(), dv.abs()


def _bert_sp_pass(model, stacked, ids, mask, cot):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), stacked)
    out = model(leaves, ids, attention_mask=mask)
    (out * cot).sum().backward()
    return out.detach(), [leaf.grad for leaf in tree_leaves(leaves)]


def phase_bert_sp(ledger: Ledger, device, profile: bool) -> dict:
    """Rows 6-8 at this phase's blocks (:func:`bert_sp_kernels`), then the
    BERT-Large encoder's width (hidden 1024, 16 heads of 64, FFN 4096,
    bf16 compute) at tp 1 x sp 4 over SP_SEQ tokens, cut to SP_LAYERS
    layers: a forward and a backward (a seeded cotangent on the f32 output)
    through the CUDA kernels, and the same pass with the ring's block
    calls through the plain versions (TF32 off).

    - Each layer's ring attention, on the inputs it got in the kernel run:
      its output and the gradients of q, k and v against the plain ring's
      within ATTENTION_TOLS plus the bf16 roundings on the way.  The output
      and dq: one ulp of the element's value (two roundings of nearly equal
      values may land one ulp apart).  dk and dv: half an ulp (round to
      nearest) for each of two roundings per ring step (each block's
      gradient and each sum of them), of the sum of the terms' magnitudes
      (the same backward through a plain dk/dv that returns magnitudes),
      since the ring sums a rotating block's gradients in bf16 and the
      terms cancel.
    - The whole pass: the encoder's output and every parameter's gradient
      within 2^-5 of its largest plain value (bf16 activations: a last-bit
      difference in attention may flip a rounding, which the next layers
      carry).
    - Launches exact: each layer makes RANKS block calls (one per ring
      step, the ranks folded into the batch), so SP_LAYERS x RANKS of each
      of rows 6-8 in the counted pass.  Returns the counts."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = bert_large_config(num_layers=SP_LAYERS, max_position_embeddings=SP_SEQ, sp_axis="intra",
                            compute_dtype=torch.bfloat16)
    group = BaguaProcessGroup([device] * RANKS, intra_size=RANKS)
    model, params = init_bert(cfg, torch.Generator(device=device).manual_seed(0), device, group, model_cls=BertModel)
    stacked = lp.replicate(params, RANKS)
    del params
    ids, mask, lengths = bert_sp_inputs(device)
    cot = torch.randn((RANKS, SP_BATCH, SP_SEQ // RANKS, cfg.hidden_size),
                      generator=torch.Generator(device=device).manual_seed(11), device=device)
    dead = [(r, s) for r in range(RANKS) for s in range(SP_BATCH) if not mask[r, s].any()]
    if not dead:
        raise AssertionError(f"[bert-sp] lengths {lengths} leave no block wholly padded")
    bert_sp_kernels(ledger, mask, device)
    with _no_tf32():
        _bert_sp_pass(model, stacked, ids, mask, cot)  # warm-up
        records = []
        torch.cuda.synchronize()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with _recorded_attention(records):
            out, grads = _bert_sp_pass(model, stacked, ids, mask, cot)
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        kernel_ms = start.elapsed_time(end)
        with _plain_attention():
            start.record()
            out_p, grads_p = _bert_sp_pass(model, stacked, ids, mask, cot)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            worst, failed = {}, []
            for layer, rec in enumerate(records):
                q, k, v = (rec[n].clone().requires_grad_() for n in "qkv")
                o = ring_attention(q, k, v, group, cfg.sp_axis, causal=False, kv_mask=rec["mask"])
                o.backward(rec["dout"])
                k_abs, v_abs = (rec[n].clone().requires_grad_() for n in "kv")
                fa.flash_attention_bwd_dkv = _abs_dkv
                ring_attention(rec["q"], k_abs, v_abs, group, cfg.sp_axis, causal=False,
                               kv_mask=rec["mask"]).backward(rec["dout"])
                fa.flash_attention_bwd_dkv = fa.flash_attention_bwd_dkv_plain
                pairs = (("output", rec["out"], o.detach(), ATTENTION_TOLS["block_attention"][0], 1, None),
                         ("dq", rec["dq"], q.grad, ATTENTION_TOLS["flash_attention_bwd_dq"][0], 1, None),
                         ("dk", rec["dk"], k.grad, ATTENTION_TOLS["flash_attention_bwd_dkv"][0], 2 * RANKS / 2,
                          k_abs.grad),
                         ("dv", rec["dv"], v.grad, ATTENTION_TOLS["flash_attention_bwd_dkv"][1], 2 * RANKS / 2,
                          v_abs.grad))
                for name, got, want, tol, ulps, scale in pairs:
                    share = _share_of_bound(got, want, tol, ulps, scale)
                    worst[name] = max(worst.get(name, 0.0), share)
                    if got.dtype != want.dtype or share > 1.0:
                        failed.append(f"layer {layer} {name}: max abs error {abs_err(got, want):.3e}, "
                                      f"{share:.3f} of the bound")
    if failed:
        raise AssertionError(f"[bert-sp] ring attention differs from the plain ring's beyond ATTENTION_TOLS "
                             f"and the bf16 roundings: {failed}")
    if len(records) != SP_LAYERS:
        raise AssertionError(f"[bert-sp] {len(records)} ring attention calls, want {SP_LAYERS}")
    rel = {}
    for (name, _), g, w in zip([("output", None)] + tree_flatten_with_names(stacked), [out] + grads,
                               [out_p] + grads_p):
        rel[name] = abs_err(g, w) / max(float(w.abs().max()), 1e-30) if torch.isfinite(g).all() else math.inf
    over = {name: r for name, r in rel.items() if r > 2.0 ** -5}
    if over:
        raise AssertionError(f"[bert-sp] kernels vs plain beyond 2^-5 of the largest value: {over}")
    calls = SP_LAYERS * RANKS
    want = {kernel: calls if kernel in ATTENTION_TOLS else 0 for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"[bert-sp] launch counts {launches}, want {want}")
    worst_leaf = max(rel, key=rel.get)
    log(f"[bert-sp] BERT-Large encoder width ({cfg.hidden_size} hidden, {cfg.num_heads} heads of "
        f"{cfg.hidden_size // cfg.num_heads}, FFN {cfg.intermediate_size}), {SP_LAYERS} layers, bf16, "
        f"{SP_BATCH} x {SP_SEQ} tokens over sp {RANKS}, padding lengths {lengths} (wholly padded blocks, "
        f"(rank, sequence): {dead}): forward + backward {kernel_ms:.2f} ms through the kernels, {plain_ms:.2f} ms "
        f"through the plain block functions; per layer within ATTENTION_TOLS and the bf16 roundings, "
        f"worst shares of the bound { {k: round(e, 4) for k, e in worst.items()} }; whole pass worst relative error {rel[worst_leaf]:.3e} "
        f"({worst_leaf}); launches {launches} ({SP_LAYERS} layers x {RANKS} ring steps)")
    if profile:
        profile_step("BERT-Large encoder sp 4 forward + backward",
                     lambda: _bert_sp_pass(model, stacked, ids, mask, cot))
    del model, stacked
    return launches


# ---------------------------------------------------------------------------
# The MoE slice (BASELINE config 5) and ResNet-50 (config 4): no kernel of
# rows 1-9 runs here (routing, dispatch/combine, the experts, BatchNorm and
# the convolutions are plain torch, as the JAX package computes them outside
# any Pallas kernel); each phase checks that none is launched
# ---------------------------------------------------------------------------

REF_MOE = dict(model_dim=16, hidden_size=32, num_experts=8)
REF_MOE_TOKENS = 64  # a rank
MOE_ASYNC = {"sync_interval_ms": 50, "warmup_steps": 2}
MOE_EXAMPLE_STEPS = 50
FUSED_TOKENS = 512  # a rank, as the JAX bench's fused all-to-all row
RESNET_STEPS, RESNET_WARMUP = 7, 2
RESNET_ALGORITHMS = ("gradient_allreduce", "decentralized")


def _no_launches(what: str) -> dict:
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"{what}: launch counts {launches}, want none")
    return launches


def _moe_pass(moe, x, cot, used=None):
    """One forward and backward of ``moe`` (a rank's tokens, no vmap):
    output, routing, balance loss, input and parameter gradients."""
    xx = x.detach().clone().requires_grad_(True)
    with torch.no_grad():
        routing = moe.moe_layer.gate(xx.reshape(-1, x.shape[-1]), used_token=None if used is None else used.reshape(-1))
    out, l_aux = moe(xx, used_token=used)
    ((out * cot).sum() + 0.3 * l_aux).backward()
    return out.detach().cpu(), routing, l_aux.detach().cpu(), xx.grad.cpu(), {
        n: p.grad.cpu() for n, p in moe.named_parameters()}


def phase_moe_reference(device) -> None:
    """``[moe-ref]``: a small MoE (16 wide, 8 experts) on the card against the
    same on the CPU (f32, TF32 off), top-1 and top-2 at a capacity factor
    that truncates (0.5) and with ``used_token`` masking a third of the
    tokens: dispatch masks and ``tokens_per_expert`` equal, combine weights
    within 1e-6 of 1, outputs and gradients within 1e-5 of their scale (the
    card's GEMMs sum in another order); then at ep RANKS under ``vmap`` on
    the card: ``a2a_chunks`` 2 and 4 bitwise equal to unchunked, and ep
    RANKS equal to ep 1 with the experts tiled within rtol 2e-4, atol 1e-5
    (the JAX package's own bound for that case)."""
    reset_launches()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, REF_MOE_TOKENS // 4, REF_MOE["model_dim"], generator=gen)
    cot = torch.randn(x.shape, generator=gen)
    used = (torch.rand(x.shape[:2], generator=gen) > 1 / 3).float()
    with _no_tf32():
        for k in (1, 2):
            for mask in (None, used):
                what = f"[moe-ref] top-{k}{' used_token' if mask is not None else ''}"
                cpu_moe = MoE(REF_MOE["model_dim"], REF_MOE["hidden_size"], REF_MOE["num_experts"], k=k,
                              capacity_factor=0.5, min_capacity=1, device="cpu",
                              generator=torch.Generator().manual_seed(k))
                card_moe = copy.deepcopy(cpu_moe).to(device)
                want = _moe_pass(cpu_moe, x, cot, mask)
                got = _moe_pass(card_moe, x.to(device), cot.to(device), None if mask is None else mask.to(device))
                rw, rg = want[1], got[1]
                if not (torch.equal(rg.dispatch_mask.cpu(), rw.dispatch_mask)
                        and torch.equal(rg.tokens_per_expert.cpu(), rw.tokens_per_expert)):
                    raise AssertionError(f"{what}: routing masks or tokens_per_expert differ card vs CPU")
                if not close(rg.combine_weights.cpu(), rw.combine_weights, 1e-6) or \
                        not close(got[2], want[2], 1e-6):
                    raise AssertionError(f"{what}: combine weights or l_aux beyond 1e-6")
                scale = lambda t: max(float(t.abs().max()), 1e-30)  # noqa: E731
                errs = [abs_err(got[0], want[0]) / scale(want[0]), abs_err(got[3], want[3]) / scale(want[3])]
                errs += [abs_err(got[4][n], want[4][n]) / scale(want[4][n]) for n in want[4]]
                if max(errs) > 1e-5:
                    raise AssertionError(f"{what}: output/gradients {max(errs):.3e} of their scale, over 1e-5")
                kept = int(rw.dispatch_mask.sum())
                log(f"{what}: masks equal ({kept} token slots kept of {REF_MOE_TOKENS * k} choices), "
                    f"outputs and gradients within {max(errs):.2e} of their scale")

        group = BaguaProcessGroup([device] * RANKS, intra_size=1)
        xs = torch.randn(RANKS, REF_MOE_TOKENS, REF_MOE["model_dim"], generator=gen).to(device)


        ep1 = MoE(REF_MOE["model_dim"], REF_MOE["hidden_size"], REF_MOE["num_experts"], k=2, capacity_factor=2.0,
                  device=device, generator=torch.Generator(device=device).manual_seed(3))
        local = {n: p.detach() for n, p in ep1.named_parameters()}
        per_rank = REF_MOE["num_experts"] // RANKS
        # the local model's experts r*per_rank.. go to rank r; the gate is everyone's
        stacked = {n: (p.reshape(RANKS, per_rank, *p.shape[1:]) if "experts" in n else p.expand(RANKS, *p.shape))
                   for n, p in local.items()}
        outs = {}
        with torch.no_grad():
            for chunks in (1, 2, 4):
                moe_c = MoE(REF_MOE["model_dim"], REF_MOE["hidden_size"], REF_MOE["num_experts"], k=2,
                            capacity_factor=2.0, ep_size=RANKS, a2a_chunks=chunks, group=group, device=device)
                outs[chunks] = torch.func.vmap(
                    lambda p, xx: torch.func.functional_call(moe_c, p, (xx,))[0])(stacked, xs)
            want = torch.stack([ep1(xs[r])[0] for r in range(RANKS)])
        for c in (2, 4):
            if not same(outs[c], outs[1]):
                raise AssertionError(f"[moe-ref] a2a_chunks {c} not bitwise equal to unchunked on the card")
        err = (outs[1] - want).abs() - (2e-4 * want.abs() + 1e-5)
        if float(err.max()) > 0:
            raise AssertionError(f"[moe-ref] ep {RANKS} vs ep 1 with tiled experts beyond rtol 2e-4, atol 1e-5")
        log(f"[moe-ref] ep {RANKS} under vmap: a2a_chunks 2 and 4 bitwise equal to unchunked; ep {RANKS} within "
            f"{abs_err(outs[1], want):.2e} of ep 1 with the experts tiled")
    _no_launches("[moe-ref]")


def phase_moe_bench(device, profile: bool) -> dict:
    """``[moe-bench]``: the ``bench_moe`` twin at full width (8 layers x 512,
    8 experts top-2, capacity 1.25, vocab 8192, bf16) over RANKS ranks x 32
    sequences of 128 on this card, ``intra_size=1``, ``gradient_allreduce``
    + Adam: 2 warm-ups, 12 timed steps.  Checks finite losses, every leaf
    bitwise equal across the ranks (ep 1: no leaf outside the exchange), no
    kernel launched; prints ms/step, the samples/s/chip line and peak
    memory, a traced step under ``--profile``; then the fused all-to-all row
    (the MoE forward at ep RANKS, FUSED_TOKENS tokens a rank, chunks 1 and
    4)."""
    gc.collect()
    torch.cuda.empty_cache()
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = bench_moe.run(group)
    launches = _no_launches("[moe-bench]")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not torch.isfinite(result.losses).all():
        raise AssertionError(f"[moe-bench]: non-finite loss {result.losses.tolist()}")
    _bitwise_replicas("[moe-bench]", result.state.params)
    n_params = sum(t[0].numel() for t in tree_leaves(result.state.params))
    line = {"metric": "moe_samples_per_sec_per_chip", "value": round(result.value, 2), "unit": "samples/s/chip",
            "config": f"hidden{bench_moe.HIDDEN} L{bench_moe.LAYERS} seq{bench_moe.SEQ} {bench_moe.EXPERTS}experts "
                      f"top{bench_moe.TOP_K}", "vs_baseline": None}
    log(f"[moe-bench] {n_params:,} parameters a rank, {RANKS} ranks x 32 x {bench_moe.SEQ} tokens, "
        f"{result.steps} timed steps: {result.step_seconds * 1e3:.1f} ms/step, "
        f"{32 * RANKS / result.step_seconds:.1f} samples/s on the card, peak memory {peak:.2f} GiB; "
        f"line {json.dumps(line)}")
    if profile:
        profile_step("MoE transformer (bench_moe twin)", lambda: result.ddp.train_step(result.state, result.batch))
    del result
    gc.collect()
    torch.cuda.empty_cache()
    row = bench_moe.fused_a2a_row(group, tokens=FUSED_TOKENS)
    log(f"[moe-bench] fused all-to-all row {json.dumps(row)}")
    _no_launches("[moe-bench] fused row")
    return launches


def phase_moe_example(device) -> dict:
    """``[moe-example]``: the moe twin's ``main()`` at its defaults (50 steps,
    one expert a rank) over RANKS ranks on this card: a finite loss, the
    non-expert leaves bitwise equal across the ranks and every expert leaf
    differing, no kernel launched."""
    reset_launches()
    t0 = time.perf_counter()
    loss, params = moe.main(["--ranks", str(RANKS)])
    seconds = time.perf_counter() - t0
    launches = _no_launches("[moe-example]")
    if not math.isfinite(loss):
        raise AssertionError(f"[moe-example]: non-finite loss {loss}")
    for name, leaf in tree_flatten_with_names(params):
        equal = [torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)]
        if ("experts" in name and all(equal)) or ("experts" not in name and not all(equal)):
            raise AssertionError(f"[moe-example]: {name} is {'' if all(equal) else 'not '}equal across the ranks")
    log(f"[moe-example] {RANKS} ranks, ep {RANKS}, {MOE_EXAMPLE_STEPS} steps: final loss {loss:.4f}; "
        f"non-expert leaves bitwise equal, expert leaves apart; {seconds:.1f} s with the set-up")
    return launches


def phase_moe_async(device) -> dict:
    """``[moe-async]`` (BASELINE config 5): the moe example's model and
    initial parameters with ``"async"`` (MOE_ASYNC: the relaxation phase's 50 ms interval)
    and the experts' ``dp_filter``, MOE_EXAMPLE_STEPS steps of the example's
    batches.  Fails unless at least one average is folded and none failed,
    if any expert leaf is among the leaves the averager averages, if a loss
    is not finite or an averager thread outlives ``shutdown()``; prints
    ms/step."""
    reset_launches()
    group = BaguaProcessGroup([device] * RANKS)
    ddp = DistributedDataParallel(moe.loss_fn(moe.build_model(group)), lambda ps: torch.optim.Adam(ps, lr=moe.LR),
                                  build_algorithm("async", **MOE_ASYNC), process_group=group,
                                  dp_filter=lambda name: "experts" not in name)
    try:
        state = ddp.init(stacked_params=moe.stacked_params(group))
        averaged = ddp.impl.averaged_names()
        if not averaged or any("experts" in n for n in averaged):
            raise AssertionError(f"[moe-async]: the averager's leaves {averaged} hold an expert leaf or none")
        rng = np.random.RandomState(0)
        protos = rng.rand(moe.CLASSES, moe.IN_FEATURES).astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MOE_EXAMPLE_STEPS):
            y = rng.randint(0, moe.CLASSES, size=64 * RANKS)
            x = protos[y] + 0.2 * rng.randn(64 * RANKS, moe.IN_FEATURES).astype(np.float32)
            state, losses = ddp.train_step(state, (torch.from_numpy(x.astype(np.float32)),
                                                   torch.from_numpy(y.astype(np.int32))))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / MOE_EXAMPLE_STEPS * 1e3
    finally:
        ddp.shutdown()
    impl = ddp.impl
    alive = [t for t in threading.enumerate() if t.name == "bagua-async-averager"]
    if impl.folds_applied < 1 or impl.folds_failed or alive or not torch.isfinite(losses).all():
        raise AssertionError(f"[moe-async]: {impl.folds_applied} folds, {impl.folds_failed} failed, "
                             f"{len(alive)} averager threads alive, losses {losses.tolist()}")
    experts_apart = all(not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS))
                        for name, leaf in tree_flatten_with_names(state.params) if "experts" in name)
    if not experts_apart:
        raise AssertionError("[moe-async]: an expert leaf is equal across the ranks")
    log(f"[moe-async] {RANKS} ranks, {MOE_EXAMPLE_STEPS} steps, async every {MOE_ASYNC['sync_interval_ms']} ms "
        f"(warmup {MOE_ASYNC['warmup_steps']}): {ms:.2f} ms/step (host clock, the whole loop), "
        f"{impl.folds_applied} folds, none failed; {len(averaged)} leaves averaged, no expert leaf among them; "
        f"final loss {float(losses.mean()):.4f}")
    return _no_launches("[moe-async]")


SMALL_RESNET_STAGES, SMALL_RESNET_CLASSES, SMALL_RESNET_IMAGE = [1, 1, 1, 1], 10, 32
SMALL_RESNET_STEPS, SMALL_RESNET_LR = 2, 0.005
# The card's f32 engine steps against the CPU's and against the f64
# recurrence: each leaf within this share of its move over the steps (the
# Frobenius norms), the losses within this rtol.  At batch 16 a rank, the
# CPU tests' size, an f32 CPU run sits 0.002-0.012 of a leaf's move (by
# host) and rtol 2e-4 from the f64 one: BatchNorm over few values a
# channel amplifies f32 rounding 1e4-1e5-fold.  The share is the CPU
# tests' f32 bound
SMALL_RESNET_BATCH, SMALL_RESNET_SHARE, SMALL_RESNET_LOSS_RTOL = 16, 0.1, 2e-3


def _small_resnet_data(batch: int):
    variables = init_resnet(ResNet(SMALL_RESNET_STAGES, SMALL_RESNET_CLASSES, device="cpu",
                                   generator=torch.Generator().manual_seed(0)))
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(RANKS, batch, SMALL_RESNET_IMAGE, SMALL_RESNET_IMAGE, 3))
    y = torch.from_numpy(rng.randint(0, SMALL_RESNET_CLASSES, (RANKS, batch)).astype(np.int32))
    return variables, x, y


def small_resnet_grads(device, batch: int = 8):
    """The losses and gradients (``batch_stats`` left out) of the small
    ResNet in f64 under ``vmap`` over RANKS ranks of ``batch`` images (the
    engine's forward), on ``device``."""
    variables, x, y = _small_resnet_data(batch)
    stacked = tree_map(lambda t: t.to(device, torch.float64).expand(RANKS, *t.shape).clone().requires_grad_(True),
                       variables)
    model = ResNet(SMALL_RESNET_STAGES, SMALL_RESNET_CLASSES, torch.float64, device=device)
    losses = torch.func.vmap(resnet_loss_fn(model))(stacked, (x.to(device), y.to(device)))
    losses.sum().backward()
    return losses.detach().cpu(), [leaf.grad.cpu() for name, leaf in tree_flatten_with_names(stacked)
                                   if "batch_stats" not in name]


def small_resnet_steps(device, dtype=torch.float32, batch: int = SMALL_RESNET_BATCH):
    """SMALL_RESNET_STEPS steps of the engine with decentralized SGD (SGD
    0.005 momentum 0.9, ``dp_filter`` on ``batch_stats``: BASELINE config
    4's step) over RANKS ranks of the small ResNet on ``device`` in
    ``dtype``, ``batch`` images a rank: the last losses, and the starting
    and final parameters as CPU f64 leaves."""
    variables, x, y = _small_resnet_data(batch)
    model = ResNet(SMALL_RESNET_STAGES, SMALL_RESNET_CLASSES, dtype, device=device)
    ddp = DistributedDataParallel(
        resnet_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=SMALL_RESNET_LR, momentum=0.9),
        DecentralizedAlgorithm(), BaguaProcessGroup([device] * RANKS, intra_size=1),
        dp_filter=lambda name: "batch_stats" not in name)
    state = ddp.init(tree_map(lambda t: t.to(device, dtype), variables))
    start = [leaf.detach().double().cpu() for leaf in tree_leaves(state.params)]
    batch_xy = (x.reshape(-1, *x.shape[2:]).to(device, dtype), y.reshape(-1).to(device))
    for _ in range(SMALL_RESNET_STEPS):
        state, losses = ddp.train_step(state, batch_xy)
    return losses.detach().double().cpu(), start, [leaf.detach().double().cpu() for leaf in tree_leaves(state.params)]


def small_resnet_f64_steps(batch: int):
    """The engine's decentralized recurrence of :func:`small_resnet_steps`
    in f64 on the CPU (the engine takes no f64): each rank's gradient at
    its own weights, the weights averaged over the ranks, SGD with momentum
    0.9 from the average; ``batch_stats`` stay.  The starting and final
    parameters."""
    variables, x, y = _small_resnet_data(batch)
    names = [name for name, _ in tree_flatten_with_names(variables)]
    weights = [t.double().expand(RANKS, *t.shape).clone() for t in tree_leaves(variables)]
    momentum = [torch.zeros_like(w) for w in weights]
    start = [w.clone() for w in weights]
    loss = torch.func.vmap(resnet_loss_fn(ResNet(SMALL_RESNET_STAGES, SMALL_RESNET_CLASSES, torch.float64,
                                                 device="cpu")))
    for _ in range(SMALL_RESNET_STEPS):
        leaves = [w.clone().requires_grad_(True) for w in weights]
        loss(tree_unflatten(variables, leaves), (x, y)).sum().backward()
        for i, name in enumerate(names):
            if "batch_stats" not in name:
                momentum[i] = 0.9 * momentum[i] + leaves[i].grad
                weights[i] = weights[i].mean(0, keepdim=True) - SMALL_RESNET_LR * momentum[i]
    return start, weights


def share_of_move(got, want, start) -> float:
    """The largest, over the leaves that moved, of ``|got - want|`` over
    ``|want - start|`` (Frobenius norms)."""
    shares = [float((g - w).norm() / (w - s).norm()) for g, w, s in zip(got, want, start)
              if float((w - s).norm()) > 0]
    return max(shares)


def check_small_resnet_on_card(device) -> dict:
    """The small ResNet on the card against the CPU: its f64 losses and
    gradients under ``vmap`` (rtol 1e-12, 1e-9 of each leaf's largest
    value), and SMALL_RESNET_STEPS f32 decentralized engine steps at batch
    SMALL_RESNET_BATCH a rank, TF32 off and cuDNN deterministic (its
    default algorithms vary from one run to the next), against the CPU's
    engine and the f64 recurrence (the losses within
    SMALL_RESNET_LOSS_RTOL, each leaf within SMALL_RESNET_SHARE of its
    move).  Raises on a miss; returns the readings."""
    card_losses, card = small_resnet_grads(device)
    cpu_losses, cpu = small_resnet_grads(torch.device("cpu"))
    grad_err = max(abs_err(a, b) / max(float(b.abs().max()), 1e-300) for a, b in zip(card, cpu))
    if not torch.allclose(card_losses, cpu_losses, rtol=1e-12, atol=0) or grad_err > 1e-9:
        raise AssertionError(f"small ResNet card vs CPU (f64): losses {card_losses.tolist()} vs "
                             f"{cpu_losses.tolist()}, gradients {grad_err:.3e} of their scale")
    with _deterministic(), _no_tf32():
        card_losses, card_start, card = small_resnet_steps(device)
    cpu_losses, cpu_start, cpu = small_resnet_steps(torch.device("cpu"))
    start, truth = small_resnet_f64_steps(SMALL_RESNET_BATCH)
    readings = {"grad_err": grad_err, "vs_cpu": share_of_move(card, cpu, cpu_start),
                "vs_f64": share_of_move(card, truth, start), "cpu_vs_f64": share_of_move(cpu, truth, start),
                "loss_rtol": float(((card_losses - cpu_losses).abs() / cpu_losses.abs()).max())}
    if (any(not torch.equal(a, b) for a, b in zip(card_start, cpu_start))
            or readings["loss_rtol"] > SMALL_RESNET_LOSS_RTOL
            or max(readings["vs_cpu"], readings["vs_f64"]) > SMALL_RESNET_SHARE):
        raise AssertionError(f"small ResNet f32 engine steps, card vs CPU: losses {card_losses.tolist()} vs "
                             f"{cpu_losses.tolist()}, readings {readings}")
    return readings


def small_resnet_witness(device) -> None:
    """Why the card's engine check is at batch 16 and not 8 (``--witness``):
    prints each f32 run's share of the f64 recurrence's move (and of the
    CPU f32 run's) at batch 8 and 16 a rank: the CPU, then the card twice
    with cuDNN's default algorithms and twice deterministic, TF32 off."""
    for batch in (8, SMALL_RESNET_BATCH):
        start, truth = small_resnet_f64_steps(batch)
        _, _, cpu = small_resnet_steps(torch.device("cpu"), torch.float32, batch)
        readings = {"cpu": share_of_move(cpu, truth, start)}
        for mode in ("default", "deterministic"):
            for run in (1, 2):
                with _no_tf32(), (_deterministic() if mode == "deterministic" else contextlib.nullcontext()):
                    _, _, card = small_resnet_steps(device, torch.float32, batch)
                readings[f"card {mode} {run}"] = share_of_move(card, truth, start)
                readings[f"card {mode} {run} vs cpu f32"] = share_of_move(card, cpu, start)
        log(f"[resnet] witness, small ResNet f32, {RANKS} ranks x {batch}, {SMALL_RESNET_STEPS} decentralized "
            f"steps, share of the f64 recurrence's move: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))


def phase_resnet(device, profile: bool, witness: bool = False) -> dict:
    """``[resnet]``: the small ResNet (stage sizes [1, 1, 1, 1], 32x32, 10
    classes) on the card against the CPU (:func:`check_small_resnet_on_card`;
    with ``--witness`` also :func:`small_resnet_witness`).  Then the imagenet twin at
    full width (BASELINE config 4): ResNet-50, 224x224, 100 classes, bf16,
    RANKS ranks x 32, ``intra_size=1``, SGD 0.005 momentum 0.9, with
    ``gradient_allreduce`` and ``decentralized``, RESNET_WARMUP + 5 steps
    each: img/s and ms/step over the timed steps, peak memory; no kernel.
    ``--profile`` then traces one decentralized step on random images."""
    reset_launches()
    r = check_small_resnet_on_card(device)
    log(f"[resnet] small ResNet [1,1,1,1]: f64 losses and gradients under vmap, {RANKS} ranks x 8, card within "
        f"{r['grad_err']:.2e} of the CPU (of each leaf's scale); {SMALL_RESNET_STEPS} f32 decentralized engine "
        f"steps, {RANKS} ranks x {SMALL_RESNET_BATCH}: card within {r['vs_cpu']:.3e} of the CPU's and "
        f"{r['vs_f64']:.3e} of the f64 recurrence's move (CPU f32 {r['cpu_vs_f64']:.3e}; bound "
        f"{SMALL_RESNET_SHARE}), losses within rtol {r['loss_rtol']:.2e} of the CPU's")
    if witness:
        small_resnet_witness(device)
    for algorithm in RESNET_ALGORITHMS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, seconds = imagenet.main(["--arch", "resnet50", "--algorithm", algorithm, "--ranks", str(RANKS),
                                       "--intra-size", "1", "--image-size", str(IMAGE_SIZE), "--batch-size",
                                       str(BATCH_PER_RANK), "--steps", str(RESNET_STEPS)])
        if not math.isfinite(loss):
            raise AssertionError(f"[resnet] {algorithm}: non-finite loss {loss}")
        timed = seconds[RESNET_WARMUP:]
        step_ms = statistics.mean(timed) * 1e3
        log(f"[resnet] ResNet-50 {IMAGE_SIZE}x{IMAGE_SIZE} bf16, {RANKS} ranks x {BATCH_PER_RANK}, {algorithm}: "
            f"{step_ms:.1f} ms/step over {len(timed)} steps (each {[round(t * 1e3, 1) for t in timed]}), "
            f"{BATCH_PER_RANK * RANKS / statistics.mean(timed):.1f} img/s on the card, warm-up steps "
            f"{[round(t, 3) for t in seconds[:RESNET_WARMUP]]} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; final loss {loss:.4f}")
    if profile:
        gc.collect()
        torch.cuda.empty_cache()
        params, loss_fn, dp_filter = imagenet.build("resnet50", IMAGE_SIZE, imagenet.CLASSES, device)
        ddp = DistributedDataParallel(loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.005, momentum=0.9),
                                      DecentralizedAlgorithm(), BaguaProcessGroup([device] * RANKS, intra_size=1),
                                      dp_filter=dp_filter)
        state = ddp.init(params)
        gen = torch.Generator(device=device).manual_seed(0)
        n = RANKS * BATCH_PER_RANK
        batch = (torch.rand(n, IMAGE_SIZE, IMAGE_SIZE, 3, device=device, generator=gen),
                 torch.randint(0, imagenet.CLASSES, (n,), device=device, generator=gen, dtype=torch.int32))
        state, _ = ddp.train_step(state, batch)  # warm-up
        profile_step("ResNet-50 decentralized", lambda: ddp.train_step(state, batch))
        del ddp, state, params
    return _no_launches("[resnet]")


# ---------------------------------------------------------------------------
# GPT: pipeline parallelism, FSDP and the gpt_pretrain twin.  Rows 6-8 run on
# the pp x sp path, through the contiguous causal ring at head dim 64; the
# pipeline and FSDP add no kernel
# ---------------------------------------------------------------------------

#: the reference phase's small GPT over 2 ranks: 2 layers, hidden 128, 2
#: heads of 64, 256 tokens
REF_GPT = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                    max_position_embeddings=256)
REF_GPT_BATCH = 2
#: layout -> (sp_axis, sp_layout, tp_size): each over a group of 2 ranks
REF_GPT_LAYOUTS = {
    "sp 2 contiguous": ("intra", "contiguous", 1),
    "sp 2 zigzag": ("intra", "zigzag", 1),
    "tp 2": (None, "contiguous", 2),
}
#: the small GPT card against CPU (f32, TF32 off): logits within 1e-4 of
#: their largest CPU value, each gradient within 1e-4 of its leaf's largest
#: (the kernels' and cuBLAS's sums against the CPU's, through 2 layers)
REF_GPT_TOL = 1e-4
#: the gpt_pretrain twin at GPT-2 small's widths (GPTConfig's defaults):
#: 12 blocks as 2 stages of 6, pp 2 x sp 2, 8 x 1024 tokens, 4 microbatches
GPT2_ARGS = ["--pp", "2", "--tp", "1", "--sp", "2", "--vocab", "50257", "--hidden", "768", "--heads", "12",
             "--blocks-per-stage", "6", "--seq", "1024", "--batch", "8", "--microbatches", "4"]
GPT_WARMUP, GPT_STEPS = 2, 5
#: the pipeline's memory at pp 4: sp 1, 3 blocks a stage, 8 microbatches
PP_MEM_ARGS = ["--pp", "4", "--tp", "1", "--sp", "1", "--vocab", "50257", "--hidden", "768", "--heads", "12",
               "--blocks-per-stage", "3", "--seq", "1024", "--batch", "8", "--microbatches", "8"]
#: FSDP: GPTModel at GPT-2 small (bf16 compute), 4 ranks x 4 sequences of
#: 1024 tokens, Adam
FSDP_CFG = GPTConfig(compute_dtype=torch.bfloat16)
FSDP_BATCH, FSDP_SEQ, FSDP_LR = 4, 1024, 1e-3


def _gpt_pass(model, stacked, ids, cot):
    """Logits and every leaf's gradient of ``sum(logits * cot)``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), stacked)
    logits = model(leaves, ids)
    (logits * cot).sum().backward()
    return logits.detach(), [leaf.grad for leaf in tree_leaves(leaves)]


def _small_gpt_run(device, layout, params, ids, cot, plain=False):
    """The small GPT over 2 ranks in ``layout`` on ``device``: ids ``(B, T)``
    global (already in the layout's order) sharded over sp, or whole on
    both tp ranks; returns the logits and the gradients on the CPU."""
    sp_axis, sp_layout, tp = REF_GPT_LAYOUTS[layout]
    cfg = dataclasses.replace(REF_GPT, sp_axis=sp_axis, sp_layout=sp_layout, tp_size=tp)
    group = BaguaProcessGroup([device] * 2, intra_size=2)
    model = GPTModel(cfg, group, device=device)
    stacked = lp.replicate(tree_map(lambda t: t.to(device), params), 2)
    B, T = ids.shape
    shards = ids.reshape(B, 2, T // 2).transpose(0, 1) if sp_axis else ids[None].expand(2, B, T)
    with _plain_attention() if plain else contextlib.nullcontext():
        out, grads = _gpt_pass(model, stacked, shards.to(device), cot.to(device))
    return out.cpu(), [g.cpu() for g in grads]


def check_small_gpt_on_card(device, layout) -> dict:
    """The small GPT (REF_GPT) in ``layout`` (REF_GPT_LAYOUTS) on the card
    against the same pass on the CPU and against the card's ring through the
    plain block functions, within REF_GPT_TOL; rows 6-8 launched exactly
    once per block call of the ring (sp layouts) or not at all (tp 2, plain
    attention).  Returns the launches and the worst relative errors."""
    sp_axis, sp_layout, tp = REF_GPT_LAYOUTS[layout]
    gen = torch.Generator().manual_seed(7)
    cfg = dataclasses.replace(REF_GPT, tp_size=tp)
    _, params = init_gpt(cfg, gen, device="cpu")
    T = REF_GPT.max_position_embeddings
    ids = torch.randint(0, REF_GPT.vocab_size, (REF_GPT_BATCH, T), generator=gen)
    if sp_layout == "zigzag":
        ids = ids[:, zigzag_order(T, 2)]
    t_local = T // 2 if sp_axis else T
    cot = torch.randn((2, REF_GPT_BATCH, t_local, REF_GPT.vocab_size), generator=gen)
    with _no_tf32():
        reset_launches()
        got = _small_gpt_run(device, layout, params, ids, cot)
        launches = read_launches()
        plain = _small_gpt_run(device, layout, params, ids, cot, plain=True)
    want = _small_gpt_run(torch.device("cpu"), layout, params, ids, cot)
    what = f"[gpt-ref] small GPT ({layout})"
    worst = {}
    names = ["logits"] + [n for n, _ in tree_flatten_with_names(params)]
    for against, ref in (("CPU", want), ("plain ring on the card", plain)):
        for name, g, w in zip(names, [got[0]] + got[1], [ref[0]] + ref[1]):
            rel = abs_err(g, w) / max(float(w.abs().max()), 1e-30)
            worst[against] = max(worst.get(against, 0.0), rel)
            if not torch.isfinite(g).all() or rel > REF_GPT_TOL:
                raise AssertionError(f"{what}: {name} differs from the {against} by {rel:.3e} of its "
                                     f"largest value (tolerance {REF_GPT_TOL})")
    # sp 2: the contiguous ring's 2 calls a pass, the zigzag ring's 2 sp + 1 = 5
    per_layer = 0 if sp_axis is None else (2 if sp_layout == "contiguous" else 5)
    calls = REF_GPT.num_layers * per_layer
    want_launches = {k: calls if k in ATTENTION_TOLS else 0 for k in KERNELS}
    if launches != want_launches:
        raise AssertionError(f"{what}: launch counts {launches}, want {want_launches}")
    return dict(launches=launches, worst=worst)


def check_pipelines_on_card(device) -> str:
    """``pipeline_apply`` (with its gradients), ``pipeline_loss_interleaved``
    (V = 2) and ``pipeline_train_1f1b`` on a small tanh stage over 4 ranks
    on the card, against the sequential program on the card (TF32 off):
    losses within rtol 2e-4, outputs within 2e-4, gradients within rtol 2e-3
    and atol 1e-4 (the CPU tests' bounds)."""
    S, M, MB, D = 4, 8, 3, 64
    gen = torch.Generator().manual_seed(9)
    group = BaguaProcessGroup([device] * S, intra_size=S)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"][:, None, :])

    def mse(y, t):
        return ((y - t) ** 2).mean(dim=(1, 2))

    def draw(n):
        return [{"w": torch.randn((D, D), generator=gen) * 0.5 / D ** 0.5, "b": torch.randn(D, generator=gen) * 0.1}
                for _ in range(n)]

    micro = torch.randn((M, MB, D), generator=gen).to(device)
    target = torch.randn((M, MB, D), generator=gen).to(device)
    every = lambda x: x[None].expand(S, *x.shape).contiguous()  # noqa: E731

    def oracle(stages):
        leaves = [tree_map(lambda t: t.detach().to(device, copy=True).requires_grad_(), s) for s in stages]
        outs = []
        for m in range(M):
            x = micro[m][None]
            for p in leaves:
                x = stage(tree_map(lambda t: t[None], p), x)
            outs.append(x[0])
        out = torch.stack(outs)
        loss = ((out - target) ** 2).mean(dim=(1, 2)).mean()
        loss.backward()
        return out.detach(), float(loss.detach()), [tree_map(lambda t: t.grad, p) for p in leaves]

    def close_grads(what, got, want, rows):
        for r in range(S):
            for key in ("w", "b"):
                if not torch.allclose(got[key][r], want[rows[r]][key], rtol=2e-3, atol=1e-4):
                    raise AssertionError(f"[gpt-ref] {what}: rank {r} {key} gradient differs from the "
                                         f"sequential program's by {abs_err(got[key][r], want[rows[r]][key]):.3e}")

    with _no_tf32():
        stages = draw(S)
        out, loss, grads = oracle(stages)
        params = {k: torch.stack([s[k] for s in stages]).to(device).requires_grad_() for k in ("w", "b")}
        y = pl.pipeline_apply(stage, params, every(micro), group, "intra")
        if not torch.allclose(y, every(out), rtol=2e-4, atol=2e-4):
            raise AssertionError(f"[gpt-ref] pipeline_apply differs from the sequential program by {abs_err(y, every(out)):.3e}")
        ((y - every(target)) ** 2).mean(dim=(1, 2, 3)).sum().backward()
        close_grads("pipeline_apply", {k: v.grad for k, v in params.items()}, grads, list(range(S)))

        f1b_loss, f1b = pl.pipeline_train_1f1b(stage, tree_map(lambda t: t.detach(), params), every(micro),
                                               every(target), mse, group, "intra")
        if not torch.allclose(f1b_loss.cpu(), torch.full((S,), loss), rtol=2e-4):
            raise AssertionError(f"[gpt-ref] pipeline_train_1f1b loss {f1b_loss.tolist()} vs {loss}")
        close_grads("pipeline_train_1f1b", f1b, grads, list(range(S)))

        chunks = draw(2 * S)
        _, i_loss_want, i_grads = oracle(chunks)
        stacked = {k: torch.stack([torch.stack([chunks[v * S + r][k] for v in range(2)]) for r in range(S)])
                   .to(device).requires_grad_() for k in ("w", "b")}
        i_loss = pl.pipeline_loss_interleaved(stage, stacked, every(micro), every(target), mse, group, "intra")
        if not torch.allclose(i_loss.detach().cpu(), torch.full((S,), i_loss_want), rtol=2e-4):
            raise AssertionError(f"[gpt-ref] pipeline_loss_interleaved loss {i_loss.tolist()} vs {i_loss_want}")
        i_loss.sum().backward()
        for v in range(2):
            close_grads(f"pipeline_loss_interleaved chunk {v}", {k: t.grad[:, v] for k, t in stacked.items()},
                        i_grads[v * S:(v + 1) * S], list(range(S)))
    return (f"pipeline_apply, pipeline_train_1f1b (loss {float(f1b_loss[0]):.6f} vs {loss:.6f}) and "
            f"pipeline_loss_interleaved V 2 (loss {float(i_loss[0].detach()):.6f} vs {i_loss_want:.6f}) over {S} ranks, "
            f"{M} microbatches, match the sequential program")


def _fsdp_small_step(device, params, ids):
    group = BaguaProcessGroup([device] * RANKS, intra_size=RANKS)
    model = GPTModel(REF_GPT, device=device)
    fsdp = FSDP(gpt_lm_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.5), group)
    p, o = fsdp.init(tree_map(lambda t: t.to(device), params))
    (p, o), loss = fsdp.train_step(p, o, ids.to(device))
    return float(loss), [t.cpu() for t in tree_leaves(fsdp.full_params(p))]


def check_fsdp_on_card(device) -> str:
    """One FSDP SGD step of the small GPT (REF_GPT, f32, 8 sequences of a
    quarter of its positions over RANKS ranks) on the card against the CPU's (TF32 off): the
    loss within rtol 1e-5, every parameter within 1e-5 + 1e-4 |value|."""
    gen = torch.Generator().manual_seed(11)
    _, params = init_gpt(REF_GPT, gen, device="cpu")
    ids = torch.randint(0, REF_GPT.vocab_size, (2 * RANKS, REF_GPT.max_position_embeddings // 4), generator=gen)
    with _no_tf32():
        got_loss, got = _fsdp_small_step(device, params, ids)
    want_loss, want = _fsdp_small_step(torch.device("cpu"), params, ids)
    if not math.isclose(got_loss, want_loss, rel_tol=1e-5):
        raise AssertionError(f"[gpt-ref] FSDP step loss {got_loss} vs CPU {want_loss}")
    for (name, _), g, w in zip(tree_flatten_with_names(params), got, want):
        if not torch.allclose(g, w, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"[gpt-ref] FSDP step: {name} differs from the CPU's by {abs_err(g, w):.3e}")
    moved = max(float((w - p).abs().max()) for w, p in zip(want, tree_leaves(params)))
    return f"one FSDP SGD step over {RANKS} ranks, card vs CPU: loss {got_loss:.6f} vs {want_loss:.6f}, parameters moved up to {moved:.3e}"


def phase_gpt_reference(device) -> None:
    """``[gpt-ref]``: the small GPT at sp 2 contiguous, sp 2 zigzag and tp 2
    card against CPU (:func:`check_small_gpt_on_card`), the three pipeline
    schedules against the sequential program on the card
    (:func:`check_pipelines_on_card`) and one FSDP step card against CPU
    (:func:`check_fsdp_on_card`)."""
    for layout in REF_GPT_LAYOUTS:
        res = check_small_gpt_on_card(device, layout)
        log(f"[gpt-ref] small GPT ({REF_GPT.num_layers} layers, hidden {REF_GPT.hidden_size}, "
            f"{REF_GPT.num_heads} heads of {REF_GPT.hidden_size // REF_GPT.num_heads}, {REF_GPT_BATCH} x "
            f"{REF_GPT.max_position_embeddings} tokens) at {layout}: logits and every gradient within "
            f"{ {k: float(f'{v:.3e}') for k, v in res['worst'].items()} } of their largest value; "
            f"launches {res['launches']}")
    log(f"[gpt-ref] {check_pipelines_on_card(device)}")
    log(f"[gpt-ref] {check_fsdp_on_card(device)}")


def contiguous_ring_masks(sp: int, t: int, n_ranks: int, rows: int, device):
    """The causal masks of the contiguous ring's block calls, one a ring
    step, each over the rows its call serves, for the ranks of a mesh whose
    sp axis is the last (``rows`` sequences a rank): member s holds the K/V
    of member (s - i) mod sp at step i.  Step 0: the diagonal block of
    every rank, ``(n_ranks * rows, t, t)``; step i > 0: the ranks with s >=
    i alone, ``n_ranks (sp - i) / sp`` of them, whose block lies wholly in
    their past (all true, expanded over the queries with stride 0, as the
    ring passes it)."""
    diagonal = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    masks = [diagonal.expand(n_ranks * rows, t, t).contiguous()]
    for i in range(1, sp):
        live = n_ranks * (sp - i) // sp * rows
        masks.append(torch.ones((live, 1, t), dtype=torch.bool, device=device).expand(live, t, t))
    return masks


def gpt_pp_calls(args) -> dict:
    """Rows 6-8's launches in one step of the twin: every block's ring
    makes sp block calls a pass (step i's over the ranks whose sp member is
    at least i: :func:`contiguous_ring_masks`); 1F1B runs the stage forward twice a tick
    (the step's forward and the recompute) and one backward, over ``M + 2S
    - 2`` ticks; GPipe one forward and one backward over ``S + M - 1``."""
    S, M, sp, L = args.pp, args.microbatches, args.sp, args.blocks_per_stage
    if sp == 1:
        return {k: 0 for k in KERNELS}
    if args.schedule == "1f1b":
        ticks = M + 2 * S - 2
        fwd, bwd = 2 * ticks * L * sp, ticks * L * sp
    else:
        fwd = bwd = (S + M - 1) * L * sp
    counts = {k: 0 for k in KERNELS}
    counts.update(block_attention=fwd, flash_attention_bwd_dq=bwd, flash_attention_bwd_dkv=bwd)
    return counts


def gpt_pp_kernels(ledger: Ledger, args, device) -> str:
    """Rows 6-8 at the twin's blocks (f32 q pre-scaled, f32 K/V, head dim
    64, ``heads / tp`` heads; every rank of the mesh folded into the batch,
    ``batch / dp / M`` sequences a rank) within ATTENTION_TOLS, at each ring step's call: its rows
    and mask (:func:`contiguous_ring_masks`), timed per step of ``args.schedule``."""
    R = args.dp * args.pp * args.tp * args.sp
    rows, t = args.batch // args.dp // args.microbatches, args.seq // args.sp
    h, d = args.heads // args.tp, args.hidden // args.heads
    tp = f" x tp {args.tp}" if args.tp > 1 else ""
    step = f"GPT-2 small pp {args.pp}{tp} x sp {args.sp} {args.schedule}"
    calls = gpt_pp_calls(args)
    gen = torch.Generator(device=device).manual_seed(12)
    qf, k, v, dl, do = attention_inputs(gen, device, R * rows, t, t, h, h, d)
    masks = contiguous_ring_masks(args.sp, t, R, rows, device)
    with _no_tf32():
        for i, mask in enumerate(masks):
            n = mask.shape[0]
            x = (qf[:n], k[:n], v[:n])
            check_attention(ledger, f"{step}, ring step {i} ({n} of {R * rows} rows, live share "
                            f"{float(mask.float().mean()):.3f})", *x, mask, dl[:n], do[:n])
            m = fa.block_attention_plain(*x, mask)[2]
            lib_fwd, lib_bwd = sdpa_ms(*x, mask, do[:n])
            costs = attention_cost(x[0], x[1], mask, d)
            per_mask = {name: calls[name] // len(masks) for name in ATTENTION_TOLS}
            ledger.time("block_attention", *costs[0], *x, mask, per_step=per_mask["block_attention"],
                        library=lambda: lib_fwd, step=step)
            for name, cost in zip(("flash_attention_bwd_dq", "flash_attention_bwd_dkv"), costs[1:]):
                ledger.time(name, *cost, *x, mask, m, dl[:n], do[:n], per_step=per_mask[name],
                            library=lambda: lib_bwd, step=step)
    _log_step_sums(ledger, step, f"{args.blocks_per_stage} blocks x {args.sp} ring steps (the live ranks' "
                   f"rows) x the ticks")
    return step


def _replicas(what: str, twin) -> None:
    """Embedding and head equal on every rank, each stage equal on the
    ranks of its pp coordinate, bit for bit."""
    rows = twin.pp_coord()
    for part in ("embed", "head", "stage"):
        for name, leaf in tree_flatten_with_names(twin.params[part]):
            for r in range(1, leaf.shape[0]):
                first = 0 if part != "stage" else int((rows == rows[r]).nonzero()[0])
                if not torch.equal(leaf[first], leaf[r]):
                    raise AssertionError(f"{what}: {part}{name} differs between ranks {first} and {r}")


def phase_gpt_pp(ledger: Ledger, device, profile: bool, schedule: str) -> dict:
    """``[gpt-pp]``: the gpt_pretrain twin at GPT-2 small's widths
    (GPT2_ARGS: 162,249,216 parameters: the embedding and the untied head
    38,597,376 each, 2 stages of 6 blocks, 42,527,232 each), pp 2 x sp 2 (pp
    = inter, sp = intra), f32, Adam 1e-3, with ``schedule``: GPT_WARMUP
    warm-up steps, then GPT_STEPS timed (ms/step, tokens/s, peak memory),
    every loss finite, the replicas bitwise equal and rows 6-8's launches
    exact (:func:`gpt_pp_calls`); rows 6-8 at the twin's blocks
    (:func:`gpt_pp_kernels`).  Traces one step (the card's idle share) for
    1F1B, and for GPipe under ``--profile``.  Returns the timed steps'
    launches."""
    gc.collect()
    torch.cuda.empty_cache()
    args = gp.parse_args(GPT2_ARGS + ["--steps", str(GPT_WARMUP + GPT_STEPS), "--schedule", schedule])
    twin = gp.Twin(args, device)
    data = [(twin.shard(i), twin.shard(l)) for i, l in gp.batches(args)]
    n_params = sum(leaf[0].numel() for part in ("embed", "head") for leaf in tree_leaves(twin.params[part]))
    n_params += args.pp * sum(leaf[0].numel() for leaf in tree_leaves(twin.params["stage"]))
    losses = [twin.step(*batch) for batch in data[:GPT_WARMUP]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for batch in data[GPT_WARMUP:]:
        losses.append(twin.step(*batch))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / GPT_STEPS
    launches = read_launches()
    peak = peak_memory()
    what = f"[gpt-pp] GPT-2 small pp {args.pp} x sp {args.sp} {schedule}"
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite loss {losses[:, 0].tolist()}")
    _replicas(what, twin)
    want = {k: GPT_STEPS * n for k, n in gpt_pp_calls(args).items()}
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches}, want {want}")
    tokens = args.batch * args.seq
    log(f"{what}: {n_params} parameters, {args.batch} x {args.seq} tokens, {args.microbatches} microbatches, "
        f"f32, Adam {gp.LR}: {step_s * 1e3:.1f} ms/step over {GPT_STEPS} steps = {tokens / step_s:.1f} "
        f"tokens/s on the card; peak memory {peak}; losses {losses[:, 0].tolist()}; "
        f"launches {launches} (per step {gpt_pp_calls(args)})")
    gpt_pp_kernels(ledger, args, device)
    if schedule == "1f1b" or profile:
        profile_step(what, lambda: twin.step(*data[-1]))
    del twin, data
    return launches


def phase_pp_mem(device) -> dict:
    """``[pp-mem]``: one step's peak memory of the twin at pp 4 (PP_MEM_ARGS:
    sp 1, 3 blocks a stage, 8 microbatches of one sequence), 1F1B and GPipe,
    each after a warm-up step (so both hold their Adam state); fails unless
    1F1B's peak is below GPipe's (the claim of ``pipeline.py``'s
    docstring).  sp 1 runs the plain attention: no launch."""
    peaks = {}
    reset_launches()
    for schedule in ("1f1b", "gpipe"):
        gc.collect()
        torch.cuda.empty_cache()
        args = gp.parse_args(PP_MEM_ARGS + ["--steps", "2", "--schedule", schedule])
        twin = gp.Twin(args, device)
        data = [(twin.shard(i), twin.shard(l)) for i, l in gp.batches(args)]
        twin.step(*data[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = twin.step(*data[1])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peaks[schedule] = torch.cuda.max_memory_allocated() / 2**30
        if not torch.isfinite(loss).all():
            raise AssertionError(f"[pp-mem] {schedule}: non-finite loss {loss.tolist()}")
        log(f"[pp-mem] GPT-2 small widths, pp {args.pp} x {args.blocks_per_stage} blocks, {args.microbatches} "
            f"microbatches of {args.batch // args.microbatches} x {args.seq} tokens, {schedule}: peak memory "
            f"{peaks[schedule]:.2f} GiB in a step ({ms:.1f} ms), loss {float(loss[0]):.4f}")
        del twin, data
    if not peaks["1f1b"] < peaks["gpipe"]:
        raise AssertionError(f"[pp-mem] 1F1B's peak {peaks['1f1b']:.2f} GiB is not below GPipe's "
                             f"{peaks['gpipe']:.2f} GiB")
    log(f"[pp-mem] 1F1B's peak is {peaks['gpipe'] - peaks['1f1b']:.2f} GiB below GPipe's "
        f"({peaks['1f1b'] / peaks['gpipe']:.3f} of it)")
    return _no_launches("[pp-mem]")


def phase_fsdp(device, profile: bool) -> dict:
    """``[fsdp]``: ``GPTModel`` at GPT-2 small (FSDP_CFG, bf16 compute) under
    ``FSDP`` over RANKS ranks, FSDP_BATCH sequences of FSDP_SEQ tokens a
    rank, ``lm_loss_fn``, Adam: GPT_WARMUP warm-up and GPT_STEPS timed
    steps (ms/step, peak memory), each rank's at-rest bytes (its parameter
    rows and their Adam state) against the total / RANKS; fails if a leaf
    the rule shards is held whole.  No sp: the plain attention, no
    launch."""
    gc.collect()
    torch.cuda.empty_cache()
    group = BaguaProcessGroup([device] * RANKS, intra_size=RANKS)
    model, params = init_gpt(FSDP_CFG, torch.Generator(device=device).manual_seed(0), device)
    model.requires_grad_(False)
    fsdp = FSDP(gpt_lm_loss_fn(model), lambda ps: torch.optim.Adam(ps, lr=FSDP_LR, fused=True), group,
                compute_dtype=torch.bfloat16)
    p, o = fsdp.init(params)
    dims = tree_leaves(fsdp_shardings(params, group))
    whole = [name for (name, shard), d, full in zip(tree_flatten_with_names(p), dims, tree_leaves(params))
             if d is not None and shard.shape[1 + d] * RANKS != full.shape[d]]
    if whole:
        raise AssertionError(f"[fsdp] leaves the rule shards are held whole: {whole}")
    replicated = sum(t.numel() * t.element_size() for t, d in zip(tree_leaves(params), dims) if d is None)
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    gen = torch.Generator(device=device).manual_seed(1)
    data = [torch.randint(0, FSDP_CFG.vocab_size, (RANKS * FSDP_BATCH, FSDP_SEQ), generator=gen, device=device)
            for _ in range(GPT_WARMUP + GPT_STEPS)]
    reset_launches()
    losses = []
    for ids in data[:GPT_WARMUP]:
        (p, o), loss = fsdp.train_step(p, o, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for ids in data[GPT_WARMUP:]:
        (p, o), loss = fsdp.train_step(p, o, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / GPT_STEPS
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[fsdp] non-finite loss {losses}")
    at_rest = fsdp.at_rest_bytes(p, o)
    total = 3 * param_bytes  # parameters and Adam's two moments, unsharded
    log(f"[fsdp] GPTModel at GPT-2 small ({n_params} parameters, bf16 compute), {RANKS} ranks x {FSDP_BATCH} x "
        f"{FSDP_SEQ} tokens, Adam {FSDP_LR}: {step_s * 1e3:.1f} ms/step over {GPT_STEPS} steps = "
        f"{RANKS * FSDP_BATCH * FSDP_SEQ / step_s:.1f} tokens/s on the card; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; at rest a rank holds {at_rest} B against "
        f"total / {RANKS} = {total / RANKS:.0f} B (replicated leaves {replicated} B); losses "
        f"{[round(x, 4) for x in losses]}")
    if at_rest > total / RANKS + 3 * replicated + 4 * len(tree_leaves(p)):
        raise AssertionError(f"[fsdp] a rank holds {at_rest} B at rest, more than its share")
    if profile:
        profile_step("[fsdp] GPT-2 small FSDP", lambda: fsdp.train_step(p, o, data[-1]))
    del fsdp, p, o, model
    return _no_launches("[fsdp]")


# ---------------------------------------------------------------------------
# Named meshes (MeshSpec): the group, the collectives and the engine on a
# named mesh.  Rows 1-4 ride the data axis of dp 4 x tp 2 (two collectives
# of 4 ranks each); rows 6-8 run through the three-axis twins' rings
# ---------------------------------------------------------------------------

#: [mesh-ref]'s algorithms on the small VGG: legacy dp 4 against
#: MeshSpec({"dp": 4}), and the columns of dp 4 x tp 2
MESH_REF_ALGORITHMS = {
    "f32": GradientAllReduceAlgorithm,
    "int8 ring": functools.partial(GradientAllReduceAlgorithm, wire_precision="int8"),
    "flat ByteGrad": functools.partial(ByteGradAlgorithm, hierarchical=False),
}
#: the twins' engine mode at the JAX tests' sizes (their small defaults)
MESH_ENGINE_REF = {
    "dp 4 x tp 2": ["--engine", "--dp", "4", "--tp", "2", "--sp", "1", "--steps", "3"],
    "dp 4 x fsdp 2 ZeRO": ["--engine", "--dp", "4", "--fsdp", "2", "--tp", "1", "--sp", "1", "--algo", "zero",
                           "--steps", "3"],
}
#: twin -> (example module, its learning rate, its engine mode's other arguments)
MESH_TWINS = {"Llama": (lp, 3e-3, []), "GPT": (gp, gp.LR, ["--pp", "1"])}
#: [mesh-llama]: the Llama twin's hand-scheduled mode at its default dp 2 x
#: tp 2 x sp 2, llama_7b_config's width, 2 sequences of LLAMA_SEQ tokens
MESH_LLAMA = (2, 2, 2)
MESH_LLAMA_BATCH = 2
#: [mesh-gpt]: the gpt_pretrain twin at its default pp 2 x tp 2 x sp 2 and
#: GPT-2 small's widths, none cut
MESH_GPT_ARGS = ["--pp", "2", "--tp", "2", "--sp", "2", "--vocab", "50257", "--hidden", "768", "--heads", "12",
                 "--blocks-per-stage", "6", "--seq", "1024", "--batch", "8", "--microbatches", "4"]
#: [mesh-engine]: the twin's engine mode at GPT-2 small, none cut
MESH_ENGINE_ARGS = ["--engine", "--pp", "1", "--sp", "1", "--vocab", "50257", "--hidden", "768", "--heads", "12",
                    "--blocks-per-stage", "12", "--seq", "1024", "--batch", "8"]
MESH_ENGINE_PATHS = {
    "dp 4 x tp 2 gradient_allreduce (overlap)": ["--dp", "4", "--tp", "2"],
    "dp 4 x tp 2 ZeRO": ["--dp", "4", "--tp", "2", "--algo", "zero"],
    "dp 4 x fsdp 2 ZeRO": ["--dp", "4", "--fsdp", "2", "--tp", "1", "--algo", "zero"],
}
#: the codec steps on the dp 4 x tp 2 engine: algorithm, then each kernel's
#: launches per bucket and step (the int8 ring over 4: two compresses and
#: two decompresses, 2 hops)
MESH_CODEC_STEPS = {
    "flat ByteGrad": (functools.partial(ByteGradAlgorithm, hierarchical=False),
                      {"compress_minmax_uint8": 1, "decompress_reduce_requantize": 1,
                       "decompress_minmax_uint8": 1}),
    "int8 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int8"),
                  {"compress_minmax_uint8": 2, "decompress_minmax_uint8": 2, "hop_dequant_add_requant_int8": 2}),
}


@contextlib.contextmanager
def axis_census(records):
    """Every collective's resolved axes and the thread that issued it
    appended to ``records`` as ``(axes, on_main_thread)``."""
    from bagua_tpu_torch import communication as comm

    resolve = comm._resolve

    def recording(group, axis):
        axes = resolve(group, axis)
        records.append((axes, threading.current_thread() is threading.main_thread()))
        return axes

    comm._resolve = recording
    try:
        yield
    finally:
        comm._resolve = resolve


def _mesh_vgg(device, group, name, params, overlap):
    """The small VGG's engine on ``group`` with MESH_REF_ALGORITHMS[name],
    and its initial state."""
    ddp = DistributedDataParallel(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                                  lambda ps: torch.optim.SGD(ps, lr=REF_LR), MESH_REF_ALGORITHMS[name](), group,
                                  overlap=overlap)
    return ddp, ddp.init(tree_map(lambda t: t.to(device), params))


def _mesh_vgg_run(device, group, name, params, batch, overlap):
    """REF_STEPS SGD steps of the small VGG on ``group``; returns the
    stacked parameters on the CPU."""
    ddp, state = _mesh_vgg(device, group, name, params, overlap)
    batch = tuple(t.to(device) for t in batch)
    for _ in range(REF_STEPS):
        state, _ = ddp.train_step(state, batch)
    return [leaf.cpu() for leaf in tree_leaves(state.params)]


def _mesh_exchange(device, group, name, params, grads):
    """The algorithm's exchange of the stacked ``grads`` on ``group``, as
    the engine runs it (under the data axes): the monolithic
    ``transform_gradients`` and each bucket's ``overlap_exchange``; the
    exchanged leaves of both, on the CPU."""
    ddp, state = _mesh_vgg(device, group, name, params, False)
    ctx = StepContext(group=group, step=0, plan=ddp.plan)
    with bagua.default_axes(group.data_axes):
        mono = tree_leaves(ddp.impl.transform_gradients(grads, state.params, state.algo_state, ctx)[0])
        groups = ddp.plan.group_leaves(grads)
        per_bucket = [t for bi, spec in enumerate(ddp.plan.specs)
                      for t in ddp.impl.overlap_exchange(bi, [groups[bi][sl.name] for sl in spec.slots], ctx)]
    return [t.cpu() for t in mono + per_bucket]


def check_mesh_replicas_on_card(device) -> dict:
    """The small VGG (REF_VGG, f32, TF32 off, cuDNN deterministic) on the
    card with each of MESH_REF_ALGORITHMS, monolithic and with overlap:

    - REF_STEPS steps on ``MeshSpec({"dp": 4})`` bitwise the legacy 4-rank
      group (``intra_size=1``);
    - REF_STEPS steps on ``MeshSpec({"dp": 4, "tp": 2})`` (the batch over
      dp, replicated over tp): the two tp columns bitwise equal, the codec
      kernels launched on the grouped layout (two collectives of 4);
    - the exchange alone (the monolithic stage and each bucket's overlap
      exchange) of the legacy run's first-step gradients, each rank's
      given to both its tp peers: on dp 4 x tp 2 each column bitwise the
      legacy group's.  The whole runs' columns are not held bitwise to the
      legacy run: the forward batches its GEMMs over 8 ranks there against
      4, which may sum in another order on the card; their largest
      difference is printed.

    Returns the dp 4 x tp 2 runs' launches."""
    gen = torch.Generator().manual_seed(2)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen))
    legacy = BaguaProcessGroup([device] * RANKS, intra_size=1)
    dp = BaguaProcessGroup([device] * RANKS, mesh_spec=bagua.MeshSpec({"dp": RANKS}))
    dp_tp = BaguaProcessGroup([device] * 2 * RANKS, mesh_spec=bagua.MeshSpec({"dp": RANKS, "tp": 2}))
    launches = {}
    with _no_tf32(), _deterministic():
        ddp, state = _mesh_vgg(device, legacy, "f32", params, False)
        grads = ddp._rank_grads(state.params, tuple(t.to(device) for t in batch))[1]
        paired = tree_map(lambda g: g.repeat_interleave(2, dim=0), grads)
        for name in MESH_REF_ALGORITHMS:
            want_x = _mesh_exchange(device, legacy, name, params, grads)
            got_x = _mesh_exchange(device, dp_tp, name, params, paired)
            for g, w in zip(got_x, want_x):
                if not all(same(g[2 * d + t], w[d]) for d in range(RANKS) for t in range(2)):
                    raise AssertionError(f"[mesh-ref] {name}: the exchange on dp {RANKS} x tp 2 differs from "
                                         "the legacy group's")
            for overlap in (False, True):
                what = f"[mesh-ref] small VGG, {name}{' (overlap)' if overlap else ''}"
                want = _mesh_vgg_run(device, legacy, name, params, batch, overlap)
                got = _mesh_vgg_run(device, dp, name, params, batch, overlap)
                if not all(same(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{what}: MeshSpec dp {RANKS} differs from the legacy group")
                reset_launches()
                cols = _mesh_vgg_run(device, dp_tp, name, params, batch, overlap)
                launches[(name, overlap)] = read_launches()
                pairs = [g.reshape(RANKS, 2, *g.shape[1:]) for g in cols]
                if not all(same(p[:, 0], p[:, 1]) for p in pairs):
                    raise AssertionError(f"{what}: the tp columns of dp {RANKS} x tp 2 differ")
                apart = max(abs_err(p[:, 0], w) for p, w in zip(pairs, want))
                used = {k for k, n in launches[(name, overlap)].items() if n}
                want_used = set(MESH_CODEC_STEPS[name][1]) if name in MESH_CODEC_STEPS else set()
                if used != want_used:
                    raise AssertionError(f"{what}: kernels launched on dp {RANKS} x tp 2: "
                                         f"{launches[(name, overlap)]}, want {sorted(want_used)}")
                log(f"{what}, {REF_STEPS} steps: MeshSpec dp {RANKS} bitwise the legacy group; dp {RANKS} x "
                    f"tp 2's two columns bitwise equal, {apart:.3e} from the legacy run at most; the exchange "
                    f"alone bitwise the legacy group's; launches on dp x tp "
                    f"{ {k: n for k, n in launches[(name, overlap)].items() if n} }")
    return launches


def _engine_run(module, argv, device, params=None):
    """A twin's engine mode under ``argv`` on ``device``: losses, the final
    stacked parameters on the CPU by name, and the engine."""
    args = module.parse_args(argv + ["--device", str(device)])
    losses, state, ddp = module.run_engine(args, device, params=params)
    return losses, [(n, t.detach().cpu()) for n, t in tree_flatten_with_names(state.params)], ddp


def check_mesh_engine_on_card(device, twin: str, config: str) -> dict:
    """A twin's engine mode (MESH_TWINS ``twin``, MESH_ENGINE_REF
    ``config``) on the card (TF32 off) against the same run on the CPU from
    the same parameters: losses within rtol 1e-5, every element of every
    rank's parameters within 3 lr and all but 1% within 1e-5 + 1e-5 |value|
    (the CPU tests' bounds against JAX; GPT's key third of each ``qkv``
    bias, whose gradient is zero in exact arithmetic, to the first bound
    only), every rank bitwise equal to rank 0; and, on dp 4 x tp 2, every exchange collective of the overlapped
    step rode ``("dp",)`` only, some from autograd's own thread (the
    hooks' thread on the card), the model's rode ``("tp",)``."""
    module, lr, extra = MESH_TWINS[twin]
    argv = MESH_ENGINE_REF[config] + extra
    want_losses, want, cpu_ddp = _engine_run(module, argv, torch.device("cpu"))
    initial = module.engine(module.parse_args(argv + ["--device", "cpu"]), torch.device("cpu"))[1].params
    initial = tree_map(lambda t: t[0].clone(), initial)
    census = []
    with _no_tf32(), axis_census(census):
        got_losses, got, ddp = _engine_run(module, argv, device, params=initial)
    what = f"[mesh-ref] {twin} engine mode {config}"
    if not torch.allclose(torch.tensor(got_losses), torch.tensor(want_losses), rtol=1e-5, atol=0.0):
        raise AssertionError(f"{what}: losses {got_losses} vs CPU {want_losses}")
    worst = 0.0
    for (name, g), (_, w) in zip(got, want):
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        tight = d > 1e-5 + 1e-5 * w.abs()
        if name.endswith("['qkv']['bias']"):
            third = g.shape[-1] // 3
            tight = torch.cat([tight[..., :third], tight[..., 2 * third:]], dim=-1)
        if float(d.max()) > 3 * lr or float(tight.float().mean()) > 0.01:
            raise AssertionError(f"{what}: parameter {name} differs from the CPU run by up to "
                                 f"{float(d.max()):.3e}, {float(tight.float().mean()):.3f} of it beyond 1e-5")
        if not all(same(g[r], g[0]) for r in range(1, g.shape[0])):
            raise AssertionError(f"{what}: the ranks' parameter {name} differs")
    model_axes = {axes for axes, _ in census if set(axes) <= set(ddp.group.model_axes)}
    exchange = [(axes, main) for axes, main in census if not set(axes) <= set(ddp.group.model_axes)]
    if any(axes != ddp.group.data_axes for axes, _ in exchange):
        raise AssertionError(f"{what}: exchange collectives rode {sorted({a for a, _ in exchange})}, "
                             f"want {ddp.group.data_axes} only")
    hooks = sum(1 for _, main in exchange if not main)
    if config == "dp 4 x tp 2" and device.type == "cuda" and not hooks:
        raise AssertionError(f"{what}: no exchange ran on autograd's thread: the overlap check saw nothing")
    log(f"{what}, card vs CPU: losses {[round(x, 5) for x in got_losses]} vs "
        f"{[round(x, 5) for x in want_losses]}, parameters within {worst:.3e}, ranks bitwise equal; "
        f"{len(exchange)} exchange collectives on {ddp.group.data_axes} ({hooks} from autograd's thread), "
        f"the model's on {sorted(model_axes)}")
    return dict(hooks=hooks, exchange=len(exchange))


def phase_mesh_reference(device) -> None:
    """``[mesh-ref]``: :func:`check_mesh_replicas_on_card`, then
    :func:`check_mesh_engine_on_card` for both twins and both engine
    configurations."""
    check_mesh_replicas_on_card(device)
    for twin in MESH_TWINS:
        for config in MESH_ENGINE_REF:
            check_mesh_engine_on_card(device, twin, config)


def mesh_llama_kernels(ledger: Ledger, device, step: str) -> None:
    """Rows 6-8 at [mesh-llama]'s blocks within ATTENTION_TOLS, timed per
    step of it: dp x tp x sp ranks folded into the batch, a sequence a
    rank, half-blocks of LLAMA_SEQ / (2 sp) tokens, 32 / tp heads of 128,
    the ring's 2 sp + 1 calls a pass (:func:`zigzag_pair_masks`) a layer;
    rank r's sp coordinate is r mod sp (sp is the mesh's last axis)."""
    dp, tp, sp = MESH_LLAMA
    cfg = llama_7b_config()
    R = dp * tp * sp
    h, d = cfg.num_heads // tp, cfg.hidden_size // cfg.num_heads
    t2 = LLAMA_SEQ // (2 * sp)
    rows = MESH_LLAMA_BATCH // dp
    gen = torch.Generator(device=device).manual_seed(13)
    qf, k, v, dl, do = attention_inputs(gen, device, R * rows, t2, t2, h, cfg.num_kv_heads // tp, d)
    blocks = {}
    for mask in zigzag_pair_masks(sp, t2, device):
        key = (mask.stride(1), mask.cpu().numpy().tobytes())
        blocks.setdefault(key, [rank_rows(mask, R // sp, rows), 0])[1] += LLAMA_LAYERS
    with _no_tf32():
        for n, (mask, calls) in enumerate(blocks.values()):
            live = float(mask.float().mean())
            check_attention(ledger, f"{step}, block {n} (live share {live:.3f})", qf, k, v, mask, dl, do)
            m = fa.block_attention_plain(qf, k, v, mask)[2]
            lib_fwd, lib_bwd = sdpa_ms(qf, k, v, mask, do)
            costs = attention_cost(qf, k, mask, d)
            ledger.time("block_attention", *costs[0], qf, k, v, mask, per_step=calls, library=lambda: lib_fwd,
                        step=step)
            for name, cost in zip(("flash_attention_bwd_dq", "flash_attention_bwd_dkv"), costs[1:]):
                ledger.time(name, *cost, qf, k, v, mask, m, dl, do, per_step=calls, library=lambda: lib_bwd,
                            step=step)
    _log_step_sums(ledger, step, f"{LLAMA_LAYERS} layers x {2 * sp + 1} live half-block pairs")


def phase_mesh_llama(ledger: Ledger, device, profile: bool) -> dict:
    """``[mesh-llama]``: LLAMA_STEPS AdamW steps of the Llama twin's
    hand-scheduled step at its default dp 2 x tp 2 x sp 2 on the named mesh
    (``lp.mesh_spec``), llama_7b_config's width, LLAMA_LAYERS layers,
    MESH_LLAMA_BATCH x LLAMA_SEQ tokens (zigzag), f32.  Checks the loss is
    finite, every rank's parameters bitwise equal (JAX replicates the one
    tree), the launches exact (steps x layers x (2 sp + 1) of each of rows
    6-8); prints ms/step, tokens/s and the peak memory; rows 6-8 at its
    blocks (:func:`mesh_llama_kernels`)."""
    gc.collect()
    torch.cuda.empty_cache()
    dp, tp, sp = MESH_LLAMA
    group = BaguaProcessGroup([device] * (dp * tp * sp), mesh_spec=lp.mesh_spec(dp, tp, sp))
    cfg = llama_7b_config(num_layers=LLAMA_LAYERS, tp_size=tp, tp_axis="tp", sp_axis="sp", sp_layout="zigzag")
    model, params = init_llama(cfg, torch.Generator(device=device).manual_seed(0), device, group)
    stacked = lp.replicate(params, group.size)
    del params
    optimizer = lp.make_optimizer(stacked, LLAMA_LR)
    loss_fn = llama_loss_fn(model)
    ids_gen = torch.Generator().manual_seed(0)
    zz = zigzag_order(LLAMA_SEQ, sp)
    batches = [lp.shard_ids(torch.randint(0, cfg.vocab_size, (MESH_LLAMA_BATCH, LLAMA_SEQ),
                                          generator=ids_gen)[:, zz], group, device, "dp", "sp")
               for _ in range(LLAMA_STEPS + 1)]
    step = functools.partial(lp.train_step, stacked, optimizer, loss_fn=loss_fn, group=group, axis=("dp", "sp"))
    n_params = sum(p[0].numel() for p in tree_leaves(stacked))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(batches[0])]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for ids in batches[1:LLAMA_STEPS]:
        losses.append(step(ids))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    peak = peak_memory()
    what = f"[mesh-llama] Llama dp {dp} x tp {tp} x sp {sp}"
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite loss {losses.tolist()}")
    _bitwise_replicas(what, stacked)
    calls = LLAMA_STEPS * LLAMA_LAYERS * (2 * sp + 1)
    want = {kernel: calls if kernel in ATTENTION_TOLS else 0 for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches}, want {want}")
    step_s = (t2 - t1) / (LLAMA_STEPS - 1)
    tokens = MESH_LLAMA_BATCH * LLAMA_SEQ
    log(f"{what} at 7B width ({cfg.hidden_size} hidden, {cfg.num_heads} heads, {cfg.intermediate_size} MLP, "
        f"vocab {cfg.vocab_size}), {LLAMA_LAYERS} layers, {n_params} parameters per rank, f32; "
        f"{MESH_LLAMA_BATCH} x {LLAMA_SEQ} tokens over {group.size} ranks, AdamW {LLAMA_LR}: first step "
        f"{t1 - t0:.3f} s, then {step_s * 1e3:.1f} ms/step = {tokens / step_s:.1f} tokens/s on the card; loss "
        f"{losses[:, 0].tolist()}; peak memory {peak}; launches {launches} ({calls} each expected: "
        f"{LLAMA_STEPS} steps x {LLAMA_LAYERS} layers x {2 * sp + 1} live half-block pairs)")
    if profile:
        profile_step(what, lambda: step(batches[-1]))
    del stacked, optimizer, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    mesh_llama_kernels(ledger, device, f"Llama dp {dp} x tp {tp} x sp {sp}")
    return launches


def phase_mesh_gpt(ledger: Ledger, device, profile: bool) -> dict:
    """``[mesh-gpt]``: the gpt_pretrain twin at its default pp 2 x tp 2 x sp
    2 at GPT-2 small's widths (MESH_GPT_ARGS, none cut), f32, Adam 1e-3,
    1F1B and GPipe: GPT_WARMUP + GPT_STEPS steps each (ms/step, tokens/s,
    peak memory), the replicas bitwise, rows 6-8's launches exact, the two
    schedules' losses within rtol 1e-4 of each other step by step; rows
    6-8 at its blocks timed per step (:func:`gpt_pp_kernels`).  Returns
    the timed steps' launches of both schedules."""
    total, losses_by = {k: 0 for k in KERNELS}, {}
    for schedule in ("1f1b", "gpipe"):
        gc.collect()
        torch.cuda.empty_cache()
        args = gp.parse_args(MESH_GPT_ARGS + ["--steps", str(GPT_WARMUP + GPT_STEPS), "--schedule", schedule])
        twin = gp.Twin(args, device)
        data = [(twin.shard(i), twin.shard(l)) for i, l in gp.batches(args)]
        losses = [twin.step(*batch) for batch in data[:GPT_WARMUP]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for batch in data[GPT_WARMUP:]:
            losses.append(twin.step(*batch))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / GPT_STEPS
        launches = read_launches()
        peak = peak_memory()
        what = f"[mesh-gpt] GPT-2 small pp {args.pp} x tp {args.tp} x sp {args.sp} {schedule}"
        losses = torch.stack(losses).cpu()
        if not torch.isfinite(losses).all():
            raise AssertionError(f"{what}: non-finite loss {losses[:, 0].tolist()}")
        _replicas(what, twin)
        want = {k: GPT_STEPS * n for k, n in gpt_pp_calls(args).items()}
        if launches != want:
            raise AssertionError(f"{what}: launch counts {launches}, want {want}")
        losses_by[schedule] = losses[:, 0]
        for k, n in launches.items():
            total[k] += n
        log(f"{what}: {args.batch} x {args.seq} tokens, {args.microbatches} microbatches, {twin.group.size} "
            f"ranks, f32, Adam {gp.LR}: {step_s * 1e3:.1f} ms/step over {GPT_STEPS} steps = "
            f"{args.batch * args.seq / step_s:.1f} tokens/s on the card; peak memory {peak}; losses "
            f"{losses[:, 0].tolist()}; launches {launches} (per step {gpt_pp_calls(args)})")
        if profile:
            profile_step(what, lambda: twin.step(*data[-1]))
        del twin, data
        gpt_pp_kernels(ledger, args, device)
    if not torch.allclose(losses_by["1f1b"], losses_by["gpipe"], rtol=1e-4, atol=0.0):
        raise AssertionError(f"[mesh-gpt] 1F1B losses {losses_by['1f1b'].tolist()} vs GPipe "
                             f"{losses_by['gpipe'].tolist()}")
    return total


@contextlib.contextmanager
def recorded_codecs(records):
    """Each codec kernel call of the exchange (ByteGrad's three, the int8
    ring's compress, decompress and hop) counted in ``records`` by kernel
    and input shapes, the first call's inputs kept: ``{(name, shapes):
    [tensors, kwargs, calls]}`` (the hop's ``bits`` in its name)."""
    from bagua_tpu_torch.algorithms import bytegrad as bg

    def recording(name, fn):
        def call(*args, **kwargs):
            tensors = [a for a in args if torch.is_tensor(a)]
            bits = [a for a in args if not torch.is_tensor(a)] + [kwargs.get("bits")]
            key = (f"{name}_int{bits[0]}" if name.startswith("hop") else name,
                   tuple(tuple(t.shape) for t in tensors))
            extra = {k: v for k, v in kwargs.items() if k != "bits"}
            rec = records.setdefault(key, [[t.clone() for t in tensors], extra, 0])
            rec[2] += 1
            return fn(*args, **kwargs)
        # the wrapper counts its launches under its own name, which now
        # finds this function: share its attributes
        call.__dict__ = fn.__dict__
        return call

    saved = [(bg, n, getattr(bg, n)) for n in ("compress_minmax_uint8", "decompress_reduce_requantize",
                                               "decompress_minmax_uint8")]
    saved += [(mm8, n, getattr(mm8, n)) for n in ("compress_minmax_uint8", "decompress_minmax_uint8")]
    saved.append((qr, "hop_dequant_add_requant", qr.hop_dequant_add_requant))
    for module, n, fn in saved:
        setattr(module, n, recording(n, fn))
    try:
        yield
    finally:
        for module, n, fn in saved:
            setattr(module, n, fn)


def _codec_cost(kernel: str, inputs):
    """(bytes, f32 operations) of one codec call on ``inputs``."""
    if kernel == "compress_minmax_uint8":
        return codec_cost(*inputs[0].shape, 6)
    if kernel == "decompress_minmax_uint8":
        return codec_cost(*inputs[0].shape, 2)
    if kernel == "decompress_reduce_requantize":
        r, n, chunk = inputs[0].shape
        return r * n * chunk + r * n * 8 + r * (chunk + 8), r * n * chunk * 3 + r * chunk * 5
    return hop_cost(inputs[2].shape[0], 8)


def mesh_codec_step(ledger: Ledger, device, name: str) -> dict:
    """One overlapped step of the GPT twin's engine model at GPT-2 small on
    dp 4 x tp 2 with MESH_CODEC_STEPS[name] (the example's bucket size,
    Adam 1e-3): the launches exact (per bucket and step), and each of rows 1-4
    bitwise against its plain version on the very inputs the step gave it,
    one of each shape, timed per step with the calls the step made of it.
    Returns the step's launches."""
    algorithm, per_bucket = MESH_CODEC_STEPS[name]
    gc.collect()
    torch.cuda.empty_cache()
    args = gp.parse_args(MESH_ENGINE_ARGS + ["--dp", "4", "--tp", "2", "--steps", "1"])
    spec = bagua.MeshSpec({"dp": 4, "tp": 2})
    group = BaguaProcessGroup([device] * spec.size, mesh_spec=spec)
    model = gp.EngineModel(args, group, device)
    # foreach Adam: the fused one on the card refuses a gradient whose
    # strides are not its parameter's, as a bucket flat's views are
    ddp = DistributedDataParallel(model.loss, lambda ps: torch.optim.Adam(ps, lr=gp.LR), algorithm(), group,
                                  bucket_size_bytes=lp.ENGINE_BUCKET_BYTES, overlap=True, dp_axis="dp",
                                  tp_axis="tp")
    state = ddp.init(params=model.params())
    ids, labels = next(gp.batches(args))
    batch = (torch.as_tensor(ids, device=device), torch.as_tensor(labels, device=device))
    records = {}
    reset_launches()
    with recorded_codecs(records):
        state, losses = ddp.train_step(state, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    buckets = ddp.plan.num_buckets
    want = {k: buckets * per_bucket.get(k, 0) for k in KERNELS}
    what = f"[mesh-engine] GPT-2 small dp 4 x tp 2, one {name} step (overlap)"
    if launches != want or not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: launches {launches}, want {want} ({buckets} buckets); "
                             f"losses {losses.tolist()}")
    if {k: sum(r[2] for (n, _), r in records.items() if n == k) for k in per_bucket} != \
            {k: want[k] for k in per_bucket}:
        raise AssertionError(f"{what}: the recorded calls do not add up to the launches")
    del ddp, state, model
    step = f"GPT-2 small engine dp 4 x tp 2 {name}"
    for (kernel, shapes), (inputs, kwargs, calls) in sorted(records.items(), key=lambda kv: str(kv[0])):
        ledger.compare(kernel, f"{step}, inputs {shapes}", *inputs, **kwargs)
        ledger.time(kernel, *_codec_cost(kernel, inputs), *inputs, per_step=calls, step=step, **kwargs)
    _log_step_sums(ledger, step, f"{buckets} buckets")
    log(f"{what}: {buckets} buckets, launches {launches} (exact), {len(records)} distinct inputs held "
        f"bitwise against the plain versions")
    records.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_mesh_engine(ledger: Ledger, device, profile: bool) -> dict:
    """``[mesh-engine]``: the GPT twin's engine mode at GPT-2 small
    (MESH_ENGINE_ARGS: 12 blocks, 1024 tokens, global batch 8, none cut),
    Adam 1e-3, on each of MESH_ENGINE_PATHS: GPT_WARMUP + GPT_STEPS steps
    (ms/step, tokens/s, peak memory; a traced step under ``--profile``),
    every rank's parameters bitwise equal (JAX replicates the tree over tp
    and fsdp), ZeRO's optimizer bytes a rank equal to the plan's Adam state
    over the exchange size; then one step of each of MESH_CODEC_STEPS
    (:func:`mesh_codec_step`).  Returns the launches of all of it."""
    total = {k: 0 for k in KERNELS}
    for path, extra in MESH_ENGINE_PATHS.items():
        gc.collect()
        torch.cuda.empty_cache()
        args = gp.parse_args(MESH_ENGINE_ARGS + extra + ["--steps", str(GPT_WARMUP + GPT_STEPS), "--device",
                                                         "cuda"])
        ddp, state = gp.engine(args, device)
        data = [(torch.as_tensor(i, device=device), torch.as_tensor(l, device=device)) for i, l in gp.batches(args)]
        losses = []
        reset_launches()
        for batch in data[:GPT_WARMUP]:
            state, step_losses = ddp.train_step(state, batch)
            losses.append(step_losses)
        torch.cuda.synchronize()
        warm_launches = read_launches()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for batch in data[GPT_WARMUP:]:
            state, step_losses = ddp.train_step(state, batch)
            losses.append(step_losses)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / GPT_STEPS
        launches = _no_launches(f"[mesh-engine] {path}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        what = f"[mesh-engine] GPT-2 small {path}"
        losses = torch.stack(losses).cpu()
        if not torch.isfinite(losses).all():
            raise AssertionError(f"{what}: non-finite loss {losses[:, 0].tolist()}")
        state = ddp.finalize_pending_updates(state)
        _bitwise_replicas(what, state.params)
        if path == MESH_OBS_PATH:  # [dist] path (b)'s single-controller run
            DIST_REFERENCES[DIST_PATH_B] = {
                "digests": gang.digests(state.params, ddp.group.size), "ms_per_step": step_s * 1e3,
                "launches": {k: n + launches[k] for k, n in warm_launches.items()},
                "losses": [row.tolist() for row in losses[:GPT_WARMUP]] + [losses[-1].tolist()]}
        opt_bytes = ddp.optimizer_state_bytes(state)
        n_params = sum(t[0].numel() for t in tree_leaves(state.params))
        note = ""
        if args.algo == "zero":
            plan_numel = sum(spec.numel for spec in ddp.plan.specs)
            share = 2 * 4 * plan_numel // ddp.group.exchange_size  # Adam's two f32 moments
            if opt_bytes != share:
                raise AssertionError(f"{what}: a rank holds {opt_bytes} B of optimizer state, want "
                                     f"{share} (the plan's {plan_numel} elements over {ddp.group.exchange_size})")
            note = f" = 2 moments x {plan_numel} elements x 4 B / {ddp.group.exchange_size}"
        tokens = args.batch * args.seq
        log(f"{what}: {n_params} parameters a rank on {ddp.group.size} ranks ({ddp.group.mesh_spec}), "
            f"{ddp.plan.num_buckets} buckets, {args.batch} x {args.seq} tokens, f32, Adam {gp.LR}: "
            f"{step_s * 1e3:.1f} ms/step over {GPT_STEPS} steps = {tokens / step_s:.1f} tokens/s on the card; "
            f"peak memory {peak:.2f} GiB; optimizer state {opt_bytes} B a rank{note}; losses "
            f"{[round(x, 4) for x in losses[:, 0].tolist()]}")
        if profile:
            profile_step(what, lambda: ddp.train_step(state, data[-1]), side=ddp.side_stream)
        if path == MESH_OBS_PATH:
            check_mesh_engine_records(ddp, state, data[-1])
        ddp.shutdown()
        del ddp, state, data
    for name in MESH_CODEC_STEPS:
        for k, n in mesh_codec_step(ledger, device, name).items():
            total[k] += n
    return total


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------

#: the small-VGG runs that every observability knob must leave bitwise as
#: they are (overlap on: the engine's default for all three)
OBS_INERT = ("ByteGrad", "int8 ring", "ZeRO f32")
#: ``[obs]``: full-width VGG16's overlap paths through ``Trainer.fit``;
#: name -> (algorithm, its arguments); the launches a step are SLICE_PATHS'
OBS_PATHS = {"ByteGrad": ("bytegrad", {}), "int8 ring": ("gradient_allreduce", {"wire_precision": "int8"})}
OBS_WARMUP, OBS_STEPS = 2, 5
#: the order of ``[obs]``'s timed turns: every knob off, the health monitor
#: alone, every knob on; each configuration twice, mirrored
OBS_TURNS = ("off", "on", "health", "health", "on", "off")
#: the least share of the exchange stream's busy time that the kernels
#: launched under an exchange label must cover in a traced overlap step
OBS_COVERAGE = 0.95
#: the ``[mesh-engine]`` path that takes one step with telemetry on
MESH_OBS_PATH = "dp 4 x tp 2 gradient_allreduce (overlap)"


def obs_knobs(log_dir: str) -> dict:
    """Every observability knob of the engine on: the telemetry hub with a
    JSONL stream in ``log_dir``, the flight recorder, a tracer writing its
    spans there too and the regression sentinel, a goodput meter priced as
    VGG16 (``model_flops_per_sample("vgg16")`` against the H100's dense
    bf16 peak), and a health monitor."""
    tel = Telemetry(metrics_jsonl=f"{log_dir}/metrics.jsonl", goodput=GoodputMeter(model="vgg16"),
                    flight="auto", tracing=Tracer(path=f"{log_dir}/spans.jsonl"), regression=RegressionSentinel())
    return {"telemetry": tel, "health_monitor": HealthMonitor()}


def _optimizer_tensors(opt) -> list:
    opts = (opt.sharded, opt.local) if hasattr(opt, "sharded") else (opt,)
    return [v for o in opts if o is not None for st in o.state.values() for v in st.values() if torch.is_tensor(v)]


def check_obs_inert_on_card(device) -> None:
    """Every observability knob on (:func:`obs_knobs`) against every one
    off, on the small VGG on the card: REF_STEPS steps of each of OBS_INERT
    with overlap (SGD with momentum, so that the optimizer has state), the
    per-step losses, the parameters and the momentum bit for bit.  The caller holds cuDNN to its deterministic
    algorithms (full-width VGG16's backward is not deterministic from one
    run to the next, so only a small model can show this)."""
    gen = torch.Generator().manual_seed(5)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen).to(device),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen).to(device))
    for name in OBS_INERT:
        runs = []
        for on in (False, True):
            with tempfile.TemporaryDirectory() as log_dir:
                knobs = obs_knobs(log_dir) if on else {}
                trainer = Trainer(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                                  lambda ps: torch.optim.SGD(ps, lr=REF_LR, momentum=0.9), REF_ALGORITHMS[name][0](),
                                  BaguaProcessGroup([device] * RANKS, intra_size=1), **knobs)
                if not trainer.ddp.overlap_enabled:
                    raise AssertionError(f"[reference] {name}: the engine resolved overlap off")
                state = trainer.init_state(tree_map(lambda t: t.to(device), params))
                losses = []
                for _ in range(REF_STEPS):
                    state = trainer.fit(state, [batch], n_steps=1)
                    losses.append(trainer.losses.clone())
                state = trainer.ddp.finalize_pending_updates(state)
                runs.append(losses + tree_leaves(state.params) + _optimizer_tensors(state.optimizer))
                trainer.close()
                if on:
                    tel = knobs["telemetry"]
                    records = tel.flight.records()
                    tel.close()
                    if not records or knobs["health_monitor"].alerts:
                        raise AssertionError(f"[reference] {name} with observability on: "
                                             f"{len(records)} flight records, alerts {knobs['health_monitor'].alerts}")
        off, on = runs
        if len(off) != len(on) or not all(same(a, b) for a, b in zip(off, on)):
            raise AssertionError(f"[reference] {name}: observability on changed the losses, parameters or "
                                 "optimizer state")
        log(f"[reference] small VGG, {REF_STEPS} {name} steps (overlap), telemetry, flight recorder, tracer, "
            f"regression sentinel, goodput meter and health monitor on vs off: {len(on)} tensors bitwise equal")


def trace_exchange(step, side, log_dir: str):
    """One call of ``step`` captured by :class:`ProfilerSession`, with a
    marker kernel on ``side`` (the overlap exchange's stream) launched
    before and after it, as :func:`profile_step` does.  Returns
    ``analyze_trace``'s result and the exchange stream's account from the
    same trace: its busy time (markers excluded), the part of it covered
    by kernels launched under an exchange label, and the part during
    which another stream also ran (profile_step's hidden share)."""
    def mark():
        with torch.cuda.stream(side):
            torch.cuda._sleep(1)
        side.synchronize()

    prof = ProfilerSession(log_dir)
    torch.cuda.synchronize()
    prof.start()
    mark()
    torch.cuda.synchronize()
    step()
    torch.cuda.synchronize()
    mark()
    prof.stop()
    analysis = analyze_trace(prof.trace_path)
    events = attribute_device_events(load_trace_events(prof.trace_path))
    streams = {e["stream"] for e in events if "spin_kernel" in e["name"]}
    if len(streams) != 1:
        raise AssertionError(f"marker kernels on streams {sorted(streams)} of the trace, want one")
    stream, = streams
    events = [e for e in events if "spin_kernel" not in e["name"]]

    def spans(pick):
        return _union((e["ts"], e["ts"] + e["dur"]) for e in events if pick(e))

    mine = spans(lambda e: e["stream"] == stream)
    labeled = spans(lambda e: e["stream"] == stream and parse_exchange_label(e["label"] or "") is not None)
    others = spans(lambda e: e["stream"] != stream)
    busy = _length(mine)
    return analysis, {"side_ms": busy / 1e3, "labeled_ms": _length(labeled) / 1e3,
                      "coverage": _length(labeled) / busy if busy else 0.0,
                      "hidden_share": _overlap_length(mine, others) / busy if busy else 0.0,
                      "trace": prof.trace_path}


def check_trace_join_on_card(device) -> dict:
    """The trace join on the card at a small size: one traced ByteGrad
    overlap step of the small VGG; every bucket has a ``per_bucket`` row,
    and the kernels launched under an exchange label cover at least
    OBS_COVERAGE of the exchange stream's busy time."""
    trainer = _small_trainer("ByteGrad", device)
    gen = torch.Generator().manual_seed(6)
    state = trainer.init_state(module_params(VGG(device=device, generator=torch.Generator(device=device)
                                                 .manual_seed(6), **REF_VGG)))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen).to(device),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen).to(device))
    state = trainer.fit(state, [batch], n_steps=1)
    ddp = trainer.ddp
    with tempfile.TemporaryDirectory() as log_dir:
        analysis, side_stream = trace_exchange(lambda: ddp.train_step(state, batch), ddp.side_stream, log_dir)
    trainer.close()
    _check_trace("[obs] small VGG ByteGrad", ddp, analysis, side_stream)
    return {"analysis": analysis, "side": side_stream}


def _check_trace(what: str, ddp, analysis: dict, side_stream: dict) -> None:
    if analysis["source"] != "device":
        raise AssertionError(f"{what}: the trace holds no kernels (source {analysis['source']!r})")
    rows = [(r["algo"], r["bucket"]) for r in analysis["per_bucket"]]
    want = [(ddp.impl.algo_name, b) for b in range(ddp.plan.num_buckets)]
    if rows != want:
        raise AssertionError(f"{what}: the trace's per-bucket rows {rows}, want {want}")
    if analysis["unattributed"] is not None:
        raise AssertionError(f"{what}: device events whose launch the trace lacks: {analysis['unattributed']}")
    if side_stream["coverage"] < OBS_COVERAGE:
        raise AssertionError(f"{what}: labeled exchange kernels cover {side_stream['coverage']:.4f} of the "
                             f"exchange stream's {side_stream['side_ms']:.3f} ms, want at least {OBS_COVERAGE}")


def _check_flight(what: str, ddp, tel, steps: int, ring_hops: bool) -> int:
    """The flight ring after ``steps`` steps: every step one exchange
    record per plan bucket in ``backward_order()``, each with its spec's
    bytes and the data axes, and with ``ring_hops`` an rs and an ag hop
    record a bucket with RANKS - 1 hops; every record retired; the dump
    validates.  Returns the records a step."""
    plan, axes = ddp.plan, list(ddp.group.data_axes)
    records = tel.flight.records()
    per_step = len(records) // steps
    for step in range(steps):
        mine = [r for r in records if r["step"] == step]
        exchange = [r for r in mine if r["phase"] != "hop"]
        if [r["bucket"] for r in exchange] != plan.backward_order():
            raise AssertionError(f"{what}: step {step}'s exchange records in bucket order "
                                 f"{[r['bucket'] for r in exchange]}, want {plan.backward_order()}")
        for r in exchange:
            if r["nbytes"] != plan.specs[r["bucket"]].nbytes or r["axes"] != axes or r["phase"] != "overlap":
                raise AssertionError(f"{what}: record {r} against its spec's {plan.specs[r['bucket']].nbytes} B, "
                                     f"axes {axes}")
        hops = [(r["bucket"], r["ring"], r["hops"]) for r in mine if r["phase"] == "hop"]
        want = [(b, leg, RANKS - 1) for b in plan.backward_order() for leg in ("rs", "ag")] if ring_hops else []
        if hops != want:
            raise AssertionError(f"{what}: step {step}'s hop records {hops}, want {want}")
        if len(mine) != per_step:
            raise AssertionError(f"{what}: step {step} has {len(mine)} records, step 0 {per_step}")
    if len(records) != steps * per_step or any(r["t_retire"] is None for r in records):
        raise AssertionError(f"{what}: {len(records)} records over {steps} steps, or some unretired")
    with tempfile.TemporaryDirectory() as d:
        dump = tel.flight.dump(flight_dump_path(d, 0), reason="manual", telemetry=tel.snapshot())
    problems = validate_flight_dump(dump)
    if problems:
        raise AssertionError(f"{what}: the flight dump does not validate: {problems[:5]}")
    return per_step


def phase_obs(device, profile: bool) -> dict:
    """``[obs]``: full-width VGG16 (224x224, 1000 classes, bf16, 32 a rank,
    RANKS ranks, ``intra_size=1``, 12 buckets of 10 MiB) through
    ``Trainer.fit`` with overlap, on each of OBS_PATHS: three trainers from
    the same weights, every observability knob off, the health monitor
    alone and every knob on (:func:`obs_knobs`), OBS_WARMUP steps each, then
    OBS_STEPS steps a turn in the order OBS_TURNS (each configuration's
    step time is the mean of its two turns).  Every turn's launches equal
    SLICE_PATHS' a bucket and step;
    with the knobs on the flight records are complete and retired
    (:func:`_check_flight`), the JSONL stream validates with one step event
    a step, no health alert fired and the monitor's loss is the mean of the
    last step's losses; one more step, traced, attributes every bucket and
    covers the exchange stream (:func:`_check_trace`).  Prints the step
    times of the three, the health norms' time on the card, MFU and goodput
    (the meter's, from the host's step walls, and at the measured step
    time), both overlap measures and the records a step.  Returns the
    launches of the timed steps."""
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    total = {k: 0 for k in KERNELS}
    flops = model_flops_per_sample("vgg16")
    n = RANKS * BATCH_PER_RANK
    for name, (algorithm, kwargs) in OBS_PATHS.items():
        per_bucket = SLICE_PATHS[name][1]
        gc.collect()
        torch.cuda.empty_cache()
        what = f"[obs] VGG16 {name} (overlap)"
        with tempfile.TemporaryDirectory() as log_dir:
            knobs = obs_knobs(log_dir)
            tel, monitor = knobs["telemetry"], knobs["health_monitor"]
            runs = {}
            for config, config_knobs in (("off", {}), ("health", {"health_monitor": HealthMonitor()}), ("on", knobs)):
                model, params = sb.build("vgg16", torch.bfloat16, device)
                trainer = Trainer(vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                                  build_algorithm(algorithm, **kwargs), group, **config_knobs)
                state = trainer.init_state(params)
                del params
                if not trainer.ddp.overlap_enabled:
                    raise AssertionError(f"{what}: the engine resolved overlap off")
                runs[config] = [trainer, state, []]
            gen = torch.Generator(device=device).manual_seed(0)
            batch = (torch.rand((n, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device),
                     torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device))
            for run in runs.values():
                run[1] = run[0].fit(run[1], itertools.repeat(batch), n_steps=OBS_WARMUP)
            buckets = runs["on"][0].ddp.plan.num_buckets
            want = {kernel: OBS_STEPS * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
            for config in OBS_TURNS:
                trainer = runs[config][0]
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                runs[config][1] = trainer.fit(runs[config][1], itertools.repeat(batch), n_steps=OBS_STEPS)
                torch.cuda.synchronize()
                runs[config][2].append((time.perf_counter() - t0) / OBS_STEPS)
                launches = read_launches()
                if launches != want:
                    raise AssertionError(f"{what}, observability {config}: launch counts {launches}, want {want}")
                if not torch.isfinite(trainer.losses).all():
                    raise AssertionError(f"{what}: non-finite loss {trainer.losses.tolist()}")
                total = {k: total[k] + c for k, c in launches.items()}
            trainer, state, _ = runs["on"]
            ddp, losses = trainer.ddp, trainer.losses
            steps = OBS_WARMUP + OBS_STEPS * OBS_TURNS.count("on")
            per_step = _check_flight(what, ddp, tel, steps, name == "int8 ring")
            tel.flush()
            problems = validate_metrics_file(f"{log_dir}/metrics.jsonl")
            with open(f"{log_dir}/metrics.jsonl") as f:
                step_events = [e for e in map(json.loads, f) if e["event"] == "step"]
            if problems or [e["step"] for e in step_events] != list(range(steps)):
                raise AssertionError(f"{what}: the JSONL stream: {problems[:5]}, step events "
                                     f"{[e['step'] for e in step_events]}")
            loss = tel.registry.snapshot()["health_loss"]
            if monitor.alerts or loss != float(losses.double().mean()):
                raise AssertionError(f"{what}: health alerts {monitor.alerts}; the monitor's loss {loss} against "
                                     f"the step's mean {float(losses.double().mean())}")
            grads = [torch.randn_like(p) for p in tree_leaves(state.params)]
            norms_ms = median_ms(lambda: grad_norms(losses, grads))
            del grads
            analysis, side = trace_exchange(lambda: ddp.train_step(state, batch), ddp.side_stream, log_dir)
            _check_trace(what, ddp, analysis, side)
            if profile:
                for config, (tr, st, _) in runs.items():
                    profile_step(f"{what}, observability {config}",
                                 lambda: tr.ddp.train_step(st, batch), side=tr.ddp.side_stream)
            ms = {config: statistics.mean(run[2]) * 1e3 for config, run in runs.items()}
            meter = tel.goodput
            walls = [e["wall_ms"] for e in step_events[OBS_WARMUP:]]
            mfu = flops * n / (ms["on"] / 1e3) / meter.peak_flops_per_chip
            turns = {config: [round(t * 1e3, 2) for t in run[2]] for config, run in runs.items()}
            log(f"{what}: {buckets} buckets; ms/step by turn ({OBS_STEPS} steps a turn, in the order "
                f"{' '.join(OBS_TURNS)}): {turns}; everything on {ms['on']:.2f} against off {ms['off']:.2f} "
                f"(ratio {ms['on'] / ms['off']:.4f}), the health monitor alone {ms['health']:.2f} (ratio "
                f"{ms['health'] / ms['off']:.4f}); the health norms {norms_ms:.3f} ms on the card; launches a turn "
                f"{want}")
            log(f"{what}, observability on: MFU {meter.last_mfu:.4f} (the meter's, from the host's step wall, "
                f"median {statistics.median(walls):.2f} ms) and {mfu:.4f} at the measured step time, against "
                f"{meter.peak_flops_per_chip:.3e} FLOP/s (a MAC counted once); goodput "
                f"{meter.ledger.goodput_frac():.4f} over {steps} steps (seconds by bucket "
                f"{ {k: round(v, 4) for k, v in meter.ledger.report()['buckets'].items() if v} }; the other "
                f"trainers' turns count as this fit loop's data wait); {per_step} flight records a step, all "
                f"retired; {len(step_events)} step events valid; health loss {loss:.6f}; traced step: "
                f"{len(analysis['per_bucket'])} buckets attributed, exchange stream {side['side_ms']:.3f} ms busy, "
                f"{side['coverage']:.4f} of it under exchange labels, overlap {analysis['measured_overlap_frac']:.4f} "
                f"(labeled kernels under compute) and {side['hidden_share']:.4f} (the exchange stream under "
                f"another stream)")
            tel.close()
            for tr, _, _ in runs.values():
                tr.close()
            del runs, trainer, state, ddp, batch
    return total


def check_mesh_engine_records(ddp, state, batch) -> None:
    """One step of the ``[mesh-engine]`` engine with a telemetry hub: every
    exchange record carries ``["dp"]`` and the step's per-axis bytes are
    the plan's, on ``dp`` alone."""
    tel = Telemetry(flight="auto")
    ddp.telemetry = tel
    ddp.train_step(state, batch)
    torch.cuda.synchronize()
    ddp.telemetry = None
    exchange = [r for r in tel.flight.records() if r["phase"] != "hop"]
    snap = tel.registry.snapshot()
    tel.close()
    by_axis = {k: v for k, v in snap.items() if k.startswith("wire_bytes_axis_")}
    if len(exchange) != ddp.plan.num_buckets or any(r["axes"] != ["dp"] for r in exchange):
        raise AssertionError(f"[mesh-engine] {MESH_OBS_PATH}: {len(exchange)} exchange records for "
                             f"{ddp.plan.num_buckets} buckets, axes {sorted({tuple(r['axes']) for r in exchange})}")
    if by_axis != {"wire_bytes_axis_dp_total": ddp.plan.total_bytes()}:
        raise AssertionError(f"[mesh-engine] {MESH_OBS_PATH}: per-axis bytes {by_axis}, want the plan's "
                             f"{ddp.plan.total_bytes()} on dp")
    log(f"[mesh-engine] {MESH_OBS_PATH}, one step with telemetry: {len(exchange)} exchange records, each on "
        f"['dp']; wire bytes by axis {by_axis}")


#: ``[resil-ref]``: the small VGG's runs: 6 steps, a preemption during step
#: 3, the resumed trainer's last 3 steps
RESIL_REF = ("ByteGrad", "int8 ring", "ZeRO f32")
RESIL_STEPS, RESIL_DRAIN_AT = 6, 3
#: ``[resil]``: warm-up steps (through one cadence snapshot, so that the
#: clones find the allocator warm), steps a turn (longer than a snapshot's
#: write, so that an on-turn runs beside a busy writer most of the way),
#: the turns' order, the cadence
RESIL_WARMUP, RESIL_TURN_STEPS = 5, 80
RESIL_TURNS = ("off", "on", "on", "off")
RESIL_EVERY = 5
#: ``[resil]``: steps the autotune session may take to re-bucket, and the
#: steps it then takes on the new plan
AUTOTUNE_STEPS, AUTOTUNE_AFTER = 8, 2


def resil_leaf_keys(params) -> list:
    """A snapshot's ``leaf_keys`` for an engine whose algorithm keeps no
    state (ByteGrad) and an SGD with momentum over ``params``: each
    parameter's path, each parameter's momentum buffer, the step."""
    names = [name for name, _ in tree_flatten_with_names(params)]
    return ([".params" + n for n in names]
            + [f".optimizer['state'][{i}]['momentum_buffer']" for i in range(len(names))] + [".step"])


class _Warnings(logging.Handler):
    """Collects the port's warnings: a best-effort fallback taken (a failed
    resume, an unreachable autotune service) logs one.  The drain's own
    notice is not a fallback."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.seen = []

    def emit(self, record):
        if not record.getMessage().startswith("preemption signal received"):
            self.seen.append(f"{record.name}: {record.getMessage()}")


@contextlib.contextmanager
def _no_warnings(what: str):
    handler = _Warnings()
    root = logging.getLogger("bagua_tpu_torch")
    root.addHandler(handler)
    try:
        yield
    finally:
        root.removeHandler(handler)
    if handler.seen:
        raise AssertionError(f"{what}: warnings logged: {handler.seen[:5]}")


def _resil_trainer(name, device, **kw):
    return Trainer(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                   lambda ps: torch.optim.SGD(ps, lr=REF_LR, momentum=0.9), REF_ALGORITHMS[name][0](),
                   BaguaProcessGroup([device] * RANKS, intra_size=1), **kw)


def _final_leaves(trainer, state) -> list:
    return state_leaves(trainer.ddp.finalize_pending_updates(state))


def _same_leaves(what: str, got, want) -> None:
    if [k for k, _ in got] != [k for k, _ in want]:
        raise AssertionError(f"{what}: leaf keys {[k for k, _ in got][:4]}... against {[k for k, _ in want][:4]}...")
    bad = [k for (k, a), (_, b) in zip(got, want) if a.dtype != b.dtype or not same(a, b)]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(got)} leaves differ, first {bad[:3]}")


def check_resil_on_card(device) -> dict:
    """``[resil-ref]`` (see the module docstring); the caller holds cuDNN to
    its deterministic algorithms.  Returns what it read."""
    gen = torch.Generator().manual_seed(7)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batches = [(torch.rand((RANKS * 8, side, side, 3), generator=gen).to(device),
                torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen).to(device))
               for _ in range(RESIL_STEPS)]
    start = lambda: tree_map(lambda t: t.to(device), params)  # noqa: E731
    seen = {}
    with _no_warnings("[resil-ref]"), tempfile.TemporaryDirectory() as root:
        for name in RESIL_REF:
            ref = _resil_trainer(name, device)
            state, want_losses = ref.init_state(start()), []
            for batch in batches:
                state = ref.fit(state, [batch])
                want_losses.append(ref.losses.clone())
            want = _final_leaves(ref, state)
            ref.close()
            routes = {"snapshot": {"snapshot_dir": f"{root}/{name}/snap", "snapshot_every": 1000}}
            if name == "ByteGrad":
                routes["checkpoint"] = {"ckpt_dir": f"{root}/{name}/ckpt", "ckpt_interval": RESIL_DRAIN_AT}
            for route, kw in routes.items():
                what = f"[resil-ref] small VGG {name}, resumed from a {route}"
                first = _resil_trainer(name, device, **kw)
                state = first.fit(first.init_state(start()), batches[:RESIL_DRAIN_AT - 1])
                if route == "snapshot":
                    first.preemption.trigger()
                    state = first.fit(state, batches[RESIL_DRAIN_AT - 1:])
                    if not first.preempted or state.step != RESIL_DRAIN_AT:
                        raise AssertionError(f"{what}: drained at step {state.step}, want {RESIL_DRAIN_AT}")
                else:
                    state = first.fit(state, batches[RESIL_DRAIN_AT - 1:RESIL_DRAIN_AT + 1])
                first.close()
                second = _resil_trainer(name, device, **kw)
                state = second.init_state(start())
                res = second.resume_result
                if state.step != RESIL_DRAIN_AT or (route == "snapshot" and (res is None or res.step != RESIL_DRAIN_AT)):
                    raise AssertionError(f"{what}: resumed at step {state.step}, result {res and res.step}")
                for i, batch in enumerate(batches[RESIL_DRAIN_AT:]):
                    state = second.fit(state, [batch])
                    if not same(second.losses, want_losses[RESIL_DRAIN_AT + i]):
                        raise AssertionError(f"{what}: step {RESIL_DRAIN_AT + i + 1}'s losses differ")
                _same_leaves(what, _final_leaves(second, state), want)
                second.close()
                seen[(name, route)] = len(want)
            if name == "ByteGrad":
                store = f"{root}/{name}/snap"
                with open(f"{store}/step_{RESIL_DRAIN_AT:07d}/manifest.json") as f:
                    manifest = json.load(f)
                with np.load(f"{store}/step_{RESIL_DRAIN_AT:07d}/proc0.npz") as z:
                    n_arrays = len(z.files)
                keys = resil_leaf_keys(params)
                if manifest["leaf_keys"] != keys or n_arrays != len(keys) or manifest["kind"] != "final":
                    raise AssertionError(f"[resil-ref] the snapshot's leaf_keys ({len(manifest['leaf_keys'])}, "
                                         f"{n_arrays} arrays, kind {manifest['kind']}) against the pinned {len(keys)}")
                seen["leaf_keys"] = len(keys)
        seen["side_stream"] = check_snapshot_copy_on_card(device, f"{root}/copy")
    log(f"[resil-ref] small VGG, {RANKS} ranks, {' / '.join(RESIL_REF)}: drained at step {RESIL_DRAIN_AT} and "
        f"resumed, {RESIL_STEPS} steps bitwise the uninterrupted run ({seen[(RESIL_REF[0], 'snapshot')]} leaves, "
        f"each resumed loss too); ByteGrad through ckpt_dir alone bitwise; the snapshot's {seen['leaf_keys']} "
        f"leaf_keys as pinned; a cadence snapshot taken while the next step ran holds its own step's "
        f"{seen['side_stream']} leaves bitwise")
    return seen


def check_snapshot_copy_on_card(device, directory: str) -> int:
    """A cadence snapshot (the side-stream copy of the clone) taken after
    step 2 while step 3 already updates the parameters in place holds step
    2's state bit for bit.  Returns the leaves compared."""
    gen = torch.Generator().manual_seed(8)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen).to(device),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen).to(device))
    trainer = _resil_trainer("ByteGrad", device, snapshot_dir=directory, snapshot_every=2)
    state = trainer.fit(trainer.init_state(tree_map(lambda t: t.to(device), params)), [batch, batch])
    want = [(k, t.clone()) for k, t in state_leaves(state)]
    state = trainer.fit(state, [batch])  # in place, while the copy may still run
    trainer.snapshotter.drain()
    trainer.close()
    with np.load(f"{directory}/step_0000002/proc0.npz") as z:
        got = [z[k] for k in sorted(z.files)]
    if len(got) != len(want):
        raise AssertionError(f"[resil-ref] the cadence snapshot holds {len(got)} leaves, want {len(want)}")
    for (key, w), g in zip(want, got):
        if not same(torch.from_numpy(g), w.cpu()):
            raise AssertionError(f"[resil-ref] the cadence snapshot's {key} is not step 2's")
    if same(state_leaves(state)[0][1], want[0][1]):
        raise AssertionError("[resil-ref] step 3 left the parameters as they were: the check proves nothing")
    return len(want)


def _turns(runs, batch, per_bucket, what) -> dict:
    """RESIL_TURNS' timed turns; returns the launches.  The writer is not
    waited for between on-turns, so that they run beside it as training
    does; an off-turn starts after it has finished (untimed).  Each turn's
    steps that started while the writer was busy are counted into
    ``runs[config][3]``."""
    total = {k: 0 for k in KERNELS}
    snap = runs["on"][0].snapshotter
    for config in RESIL_TURNS:
        trainer = runs[config][0]
        want = {k: RESIL_TURN_STEPS * trainer.ddp.plan.num_buckets * per_bucket.get(k, 0) for k in KERNELS}
        if config == "off":
            snap.drain(600.0)
        busy = []

        def batches():
            while True:
                busy.append(snap.busy)
                yield batch

        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        runs[config][1] = trainer.fit(runs[config][1], batches(), n_steps=RESIL_TURN_STEPS)
        torch.cuda.synchronize()
        runs[config][2].append((time.perf_counter() - t0) / RESIL_TURN_STEPS)
        runs[config][3].append(sum(busy[:RESIL_TURN_STEPS]))
        launches = read_launches()
        if launches != want:
            raise AssertionError(f"{what}, snapshots {config}: launch counts {launches}, want {want}")
        if not torch.isfinite(trainer.losses).all():
            raise AssertionError(f"{what}: non-finite loss {trainer.losses.tolist()}")
        total = {k: total[k] + c for k, c in launches.items()}
    return total


def _autotune(trainer, state, batch, per_bucket, what):
    """The resumed trainer's autotune session: steps until the service's
    proposal re-buckets the live engine, then AUTOTUNE_AFTER more, each
    step's launches exact for the plan it ran on.  Returns ``(state,
    launches, versions, buckets)``."""
    total = {k: 0 for k in KERNELS}
    ddp, version0, buckets = trainer.ddp, trainer.ddp.plan_version, [trainer.ddp.plan.num_buckets]
    after = None
    for i in range(AUTOTUNE_STEPS + AUTOTUNE_AFTER):
        nb = ddp.plan.num_buckets
        want = {k: nb * per_bucket.get(k, 0) for k in KERNELS}
        reset_launches()
        state = trainer.fit(state, [batch])
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != want:
            raise AssertionError(f"{what}, autotune step {i} on {nb} buckets: launches {launches}, want {want}")
        total = {k: total[k] + c for k, c in launches.items()}
        if ddp.plan.num_buckets != buckets[-1]:
            buckets.append(ddp.plan.num_buckets)
        if after is None and ddp.plan_version != version0:
            after = i
        if after is not None and i >= after + AUTOTUNE_AFTER:
            break
    if after is None:
        raise AssertionError(f"{what}: the autotune session never re-bucketed in {AUTOTUNE_STEPS} steps")
    _bitwise_replicas(what, state.params)
    return state, total, (version0, ddp.plan_version), buckets


def phase_resil(device, profile: bool) -> dict:
    """``[resil]`` (see the module docstring).  Returns the launches of the
    timed turns and the autotune steps."""
    from bagua_tpu_torch.ddp import AutotuneSession
    from bagua_tpu_torch.observability.telemetry import Telemetry
    from bagua_tpu_torch.service.autotune_client import AutotuneClient
    from bagua_tpu_torch.service.autotune_service import AutotuneService, start_autotune_server

    with _deterministic():
        check_resil_on_card(device)
    name = "ByteGrad"
    per_bucket = SLICE_PATHS[name][1]
    what = f"[resil] VGG16 {name} (overlap)"
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    n = RANKS * BATCH_PER_RANK
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="bagua_resil_")
    service = AutotuneService(world_size=1, autotune_level=1, max_samples=AUTOTUNE_STEPS,
                              sampling_confidence_time_s=0.0, warmup_time_s=0.0)
    server = start_autotune_server(service, port=0)
    try:
        with _no_warnings(what):
            runs = {}
            for config in ("off", "on"):
                kw = {"snapshot_dir": f"{root}/snaps", "snapshot_every": RESIL_EVERY, "snapshot_keep": 1} \
                    if config == "on" else {}
                model, params = sb.build("vgg16", torch.bfloat16, device)
                trainer = Trainer(vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                                  build_algorithm("bytegrad"), group, telemetry=Telemetry(flight=None), **kw)
                state = trainer.init_state(params)
                del params
                if not trainer.ddp.overlap_enabled:
                    raise AssertionError(f"{what}: the engine resolved overlap off")
                runs[config] = [trainer, state, [], []]
            gen = torch.Generator(device=device).manual_seed(0)
            batch = (torch.rand((n, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device),
                     torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device))
            for run in runs.values():
                run[1] = run[0].fit(run[1], itertools.repeat(batch), n_steps=RESIL_WARMUP)
            on = runs["on"][0]
            total = _turns(runs, batch, per_bucket, what)
            snap = on.snapshotter
            leaves = [t for _, t in state_leaves(runs["on"][1])]
            n_bytes = sum(t.numel() * t.element_size() for t in leaves)
            clone_ms = median_ms(lambda: [t.clone() for t in leaves], reps=3, calls=1, warm=1)
            del leaves
            skipped = on.telemetry.registry.snapshot().get("snapshot_skipped_total", 0)
            ms = {config: statistics.mean(run[2]) * 1e3 for config, run in runs.items()}
            turns = {config: [round(t * 1e3, 2) for t in run[2]] for config, run in runs.items()}
            busy_steps = runs["on"][3]
            written, wall_ms, clone_host_ms = snap.written, snap.last_wall_ms, snap.last_clone_ms
            if snap.last_bytes != n_bytes or written < 1:
                raise AssertionError(f"{what}: {written} snapshots written, the last {snap.last_bytes} B, "
                                     f"want the state's {n_bytes} B")
            runs["off"][0].close()
            del runs["off"]
            gc.collect()
            torch.cuda.empty_cache()

            on.preemption.trigger()
            state = on.fit(runs["on"][1], itertools.repeat(batch), n_steps=RESIL_TURN_STEPS)
            if not on.preempted or state.step != runs["on"][1].step + 1:
                raise AssertionError(f"{what}: the preemption drained at step {state.step}")
            drained, drain_ms = state_leaves(state), on.drain_ms
            model, params = sb.build("vgg16", torch.bfloat16, device)
            resumed = Trainer(vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                              build_algorithm("bytegrad"), group, snapshot_dir=f"{root}/snaps", snapshot_every=0)
            state2 = resumed.init_state(params)
            del params
            res = resumed.resume_result
            if res is None or res.step != state.step or res.plan_source != "carried":
                raise AssertionError(f"{what}: resume {res and (res.step, res.plan_source)} at drained step "
                                     f"{state.step}")
            # the session the Trainer builds for autotune_model_name, against
            # the in-process service and asking every 2 steps
            resumed._session = AutotuneSession(resumed.ddp, "vgg16",
                                               client=AutotuneClient(port=server.server_address[1]), interval=2)
            _same_leaves(f"{what}, resumed against drained", state_leaves(state2), drained)
            n_leaves = len(drained)
            on.close()
            del drained, state, runs, on
            gc.collect()
            torch.cuda.empty_cache()
            state2, tuned, versions, buckets = _autotune(resumed, state2, batch, per_bucket, what)
            total = {k: total[k] + c for k, c in tuned.items()}
            if profile:
                profile_step(f"{what}, after autotune", lambda: resumed.ddp.train_step(state2, batch),
                             side=resumed.ddp.side_stream)
            resumed.close()
            del state2, resumed
    finally:
        server.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    log(f"{what}: ms/step by turn ({RESIL_TURN_STEPS} steps a turn, in the order {' '.join(RESIL_TURNS)}): "
        f"{turns}; snapshots on {ms['on']:.2f} against off {ms['off']:.2f} (ratio {ms['on'] / ms['off']:.4f}), "
        f"cadence {RESIL_EVERY}, steps of each on-turn started with the writer busy {busy_steps}; the clone of "
        f"{n_leaves} leaves {clone_ms:.3f} ms on the card "
        f"({clone_host_ms:.3f} ms of host time to queue it); a snapshot {wall_ms:.1f} ms on the writer "
        f"thread for {n_bytes} B ({written} written, snapshot_skipped_total {skipped})")
    log(f"{what}: drain {drain_ms:.1f} ms (final snapshot, marker), resume {res.wall_ms:.1f} ms (load, "
        f"commit), {n_leaves} leaves bitwise the drained state; autotune re-bucketed the live engine "
        f"(plan version {versions[0]} -> {versions[1]}, buckets {buckets}), each step's launches exact for "
        f"its plan, replicas bitwise")
    return total


# ---------------------------------------------------------------------------
# [verify]: the static gate on the engine's main path; [autopilot]: the gang
# autopilot through the Trainer under the strict gate
# ---------------------------------------------------------------------------

#: the gate's paths: name -> (algorithm, kwargs, launches a bucket and step)
VERIFY_PATHS = {
    "f32": ("gradient_allreduce", {}, {}),
    "ByteGrad": ("bytegrad", {}, SLICE_PATHS["ByteGrad"][1]),
    "int8 ring": ("gradient_allreduce", {"wire_precision": "int8"}, SLICE_PATHS["int8 ring"][1]),
    "ZeRO int8": ("zero", {"wire_precision": "int8"}, ZERO_PATHS["ZeRO int8 ring"][2]),
}
VERIFY_STEPS = 10
#: the small VGG's gate arm: the same paths, every wire
VERIFY_SMALL_BATCH = 8


@contextlib.contextmanager
def static_verify(mode: str):
    """``BAGUA_STATIC_VERIFY`` set to ``mode`` within."""
    saved = os.environ.get("BAGUA_STATIC_VERIFY")
    os.environ["BAGUA_STATIC_VERIFY"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("BAGUA_STATIC_VERIFY", None)
        else:
            os.environ["BAGUA_STATIC_VERIFY"] = saved


def _allocations() -> int:
    return int(torch.cuda.memory_stats().get("allocation.all.allocated", 0))


class GateWatch:
    """Wraps the engine's gate (``analysis.verify_step_program``, which the
    engine calls through the module): around every call, no wrapper's
    launch count may move, ``torch.cuda.memory_allocated`` must stay as it
    was and no allocation may be made on the card; the report must be ok.
    ``calls`` keeps ``(variant, host ms, report)``; ``reject`` plants a
    rejection instead of verifying."""

    def __init__(self, what: str):
        self.what = what
        self.calls = []
        self.reject = False

    def __enter__(self):
        self._orig = tan.verify_step_program
        tan.verify_step_program = self._gate
        return self

    def __exit__(self, *exc):
        tan.verify_step_program = self._orig
        return False

    def _gate(self, ddp, state, batch, variant="default", payload=None):
        if self.reject:
            raise tan.StaticVerifyError([tan.Finding(check="plan_conformance", severity="error",
                                                     message="planted rejection")])
        # garbage of earlier runs freed now, not inside the gate
        gc.collect()
        launches, mem, allocs = read_launches(), torch.cuda.memory_allocated(), _allocations()
        t0 = time.perf_counter()
        report = self._orig(ddp, state, batch, variant=variant, payload=payload)
        ms = (time.perf_counter() - t0) * 1e3
        if read_launches() != launches:
            raise AssertionError(f"{self.what}: the gate launched kernels: {read_launches()} against {launches}")
        if torch.cuda.memory_allocated() != mem or _allocations() != allocs:
            raise AssertionError(f"{self.what}: the gate allocated on the card ({torch.cuda.memory_allocated()} "
                                 f"B against {mem}; {_allocations() - allocs} allocations)")
        if not report.ok:
            raise AssertionError(f"{self.what}: the gate rejected the engine's own program: {report.summary()}")
        self.calls.append((variant, ms, report))
        return report


def check_meta_wrappers_on_card(device) -> int:
    """Every kernel wrapper: meta tensors take the plain version (shapes
    only, no launch counted, nothing allocated on the card); the same call
    on CUDA tensors launches the kernel once.  Returns the wrappers
    checked."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((8, 64), generator=gen, device=device)
    q, mm = mm8.compress_minmax_uint8(x)
    q3, mm3 = q.reshape(2, 4, 64), mm.reshape(2, 4, 2)
    qb, qm, qx = qr.compress_minmax_uint4_plain(x)[0], mm, x
    a = torch.rand((1, 16, 2, 32), generator=gen, device=device)
    mask = torch.ones((1, 16, 16), dtype=torch.bool, device=device)
    stats = torch.zeros((1, 2, 16), device=device)
    do = torch.rand((1, 2, 16, 32), generator=gen, device=device)
    w = torch.rand((64, 32), generator=gen, device=device)
    calls = [
        (mm8.compress_minmax_uint8, (x,)),
        (mm8.decompress_minmax_uint8, (q, mm)),
        (mm8.decompress_reduce_requantize, (q3, mm3)),
        (qr.hop_dequant_add_requant, (q, mm, x, 8)),
        (qr.hop_dequant_add_requant, (qb, qm, qx, 4)),
        (qr.compress_minmax_uint4, (x,)),
        (qr.decompress_minmax_uint4, (qb, qm)),
        (fa.block_attention, (a, a, a, mask)),
        (fa.flash_attention_bwd_dq, (a, a, a, mask, stats, stats, do)),
        (fa.flash_attention_bwd_dkv, (a, a, a, mask, stats, stats, do)),
        (cm.matmul_tile, (x, w)),
    ]
    torch.cuda.synchronize()
    for fn, args in calls:
        meta = tuple(torch.empty_like(t, device="meta") if torch.is_tensor(t) else t for t in args)
        gc.collect()
        before, mem, allocs = fn.launches, torch.cuda.memory_allocated(), _allocations()
        out = fn(*meta)
        outs = out if isinstance(out, tuple) else (out,)
        if not all(t.is_meta for t in outs) or fn.launches != before:
            raise AssertionError(f"[verify] {fn.__name__} on meta tensors: launches {fn.launches - before}, "
                                 f"outputs on {[t.device.type for t in outs]}")
        if torch.cuda.memory_allocated() != mem or _allocations() != allocs:
            raise AssertionError(f"[verify] {fn.__name__} on meta tensors allocated on the card")
        real = fn(*args)
        reals = real if isinstance(real, tuple) else (real,)
        if fn.launches != before + 1 or [t.shape for t in reals] != [t.shape for t in outs]:
            raise AssertionError(f"[verify] {fn.__name__} on CUDA tensors: {fn.launches - before} launches, "
                                 f"shapes {[tuple(t.shape) for t in reals]} against meta's "
                                 f"{[tuple(t.shape) for t in outs]}")
    torch.cuda.synchronize()
    return len(calls)


def check_gate_on_card(device) -> dict:
    """The strict gate on the small VGG over RANKS ranks of the card, every
    VERIFY_PATHS path: the gate allocates and launches nothing
    (:class:`GateWatch`), then one real step runs with each wrapper's
    launches exact.  Returns the host ms of each path's gate."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(0)
    batch = (torch.rand((RANKS * VERIFY_SMALL_BATCH, REF_VGG["image_size"], REF_VGG["image_size"], 3),
                        generator=gen, device=device),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * VERIFY_SMALL_BATCH,), generator=gen, device=device))
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    with static_verify("strict"):
        for name, (algo, kw, per_bucket) in VERIFY_PATHS.items():
            what = f"[verify] small VGG {name}"
            model = VGG(device=device, generator=torch.Generator(device=device).manual_seed(0), **REF_VGG)
            trainer = Trainer(vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=REF_LR, momentum=0.9),
                              build_algorithm(algo, **kw), group, bucket_size_bytes=1 << 14)
            state = trainer.init_state(module_params(model))
            with GateWatch(what) as watch:
                reset_launches()
                state = trainer.fit(state, [batch])
                torch.cuda.synchronize()
            nb = trainer.ddp.plan.num_buckets
            want = {k: nb * per_bucket.get(k, 0) for k in KERNELS}
            if len(watch.calls) != 1 or read_launches() != want:
                raise AssertionError(f"{what}: {len(watch.calls)} gates, launches {read_launches()}, want {want}")
            if not torch.isfinite(trainer.losses).all():
                raise AssertionError(f"{what}: non-finite loss")
            out[name] = watch.calls[0][1]
            trainer.close()
    return out


def _verify_trainer(name, device, group, mode, telemetry=None):
    algo, kw, _ = VERIFY_PATHS[name]
    model, params = sb.build("vgg16", torch.bfloat16, device)
    trainer = Trainer(vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                      build_algorithm(algo, **kw), group, telemetry=telemetry)
    return trainer, trainer.init_state(params)


def phase_verify(device) -> dict:
    """``[verify]`` (see the module docstring).  Returns the launches of
    the strict runs' steps."""
    from bagua_tpu_torch.observability.goodput import PEAK_FLOPS_PER_CHIP as PEAK_FLOPS
    from bagua_tpu_torch.perflab import DEFAULT_TOPOLOGY, model_step_cell
    from bagua_tpu_torch.service.planner import CostModel

    n = RANKS * BATCH_PER_RANK
    wrappers = check_meta_wrappers_on_card(device)
    small = check_gate_on_card(device)
    log(f"[verify] {wrappers} wrappers: meta tensors take the plain versions (no launch, nothing allocated on "
        f"the card), CUDA tensors launch; the small VGG's strict gate allocates and launches nothing, host ms "
        f"{ {k: round(v, 1) for k, v in small.items()} }")
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = (torch.rand((n, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device),
             torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device))
    total = {k: 0 for k in KERNELS}
    rows = []
    for name, (algo, kw, per_bucket) in VERIFY_PATHS.items():
        what = f"[verify] VGG16 {name}"
        runs = {}
        for mode in ("off", "strict"):
            gc.collect()
            torch.cuda.empty_cache()
            with static_verify(mode), GateWatch(what) as watch:
                tel = Telemetry(flight=FlightRecorder(capacity=4096, rank=0, world_size=1), tracing=None,
                                regression=None)
                trainer, state = _verify_trainer(name, device, group, mode, tel)
                ddp = trainer.ddp
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                state = trainer.fit(state, itertools.repeat(batch), n_steps=1)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state = trainer.fit(state, itertools.repeat(batch), n_steps=VERIFY_STEPS)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                launches = read_launches()
                nb = ddp.plan.num_buckets
                want = {k: (1 + VERIFY_STEPS) * nb * per_bucket.get(k, 0) for k in KERNELS}
                if launches != want:
                    raise AssertionError(f"{what}, gate {mode}: launches {launches}, want {want}")
                if not torch.isfinite(trainer.losses).all():
                    raise AssertionError(f"{what}, gate {mode}: non-finite loss {trainer.losses.tolist()}")
                _bitwise_replicas(f"{what}, gate {mode}", ddp.finalize_pending_updates(state).params)
                runs[mode] = {"first_ms": (t1 - t0) * 1e3, "ms": (t2 - t1) * 1e3 / VERIFY_STEPS,
                              "launches": launches, "gates": [round(c[1], 1) for c in watch.calls]}
                if mode == "off":
                    if watch.calls:
                        raise AssertionError(f"{what}: the gate ran with BAGUA_STATIC_VERIFY off")
                    trainer.close()
                    del trainer, state, ddp
                    continue
                variant = ddp.impl.step_variant(0)
                if len(watch.calls) != 1:
                    raise AssertionError(f"{what}: {len(watch.calls)} gates on one variant's steps")
                report = watch.calls[0][2]
                if algo in tan.MODELED_ALGOS:
                    predicted, captured = ddp._predicted_programs.get(variant), ddp._flight_programs.get(variant)
                    if not predicted or tan.canonical_records(predicted) != tan.canonical_records(captured):
                        raise AssertionError(f"{what}: the flight capture differs from the gate's prediction")
                # a rebucket re-verifies at once; a planted rejection rolls back
                old_plan = ddp.plan
                plan2 = ddp.impl.tensors_to_buckets(ddp._tree_template, 2 * ddp.bucket_size_bytes)
                ddp.rebucket(plan2, reason="manual")
                if len(watch.calls) != 2 or ddp.plan is not plan2:
                    raise AssertionError(f"{what}: the rebucket was not re-verified")
                watch.reject = True
                try:
                    ddp.rebucket(old_plan, reason="manual")
                    raise AssertionError(f"{what}: the planted rejection did not raise")
                except tan.StaticVerifyError:
                    pass
                watch.reject = False
                if ddp.plan is not plan2:
                    raise AssertionError(f"{what}: the rejected plan was not rolled back")
                reset_launches()
                state = trainer.fit(state, itertools.repeat(batch), n_steps=1)
                torch.cuda.synchronize()
                nb2 = plan2.num_buckets
                want2 = {k: nb2 * per_bucket.get(k, 0) for k in KERNELS}
                if read_launches() != want2:
                    raise AssertionError(f"{what}: after the rebucket launches {read_launches()}, want {want2}")
                launches = runs[mode]["launches"] = {k: launches[k] + c for k, c in read_launches().items()}
                # the modeled step beside the measured one
                gc.collect()
                mem, allocs = torch.cuda.memory_allocated(), _allocations()
                cell = model_step_cell(ddp, state, batch, CostModel(),
                                       wire={"int8 ring": "int8", "ZeRO int8": "int8",
                                             "ByteGrad": "bytegrad"}.get(name, "f32"))
                if torch.cuda.memory_allocated() != mem or _allocations() != allocs or not cell.verified:
                    raise AssertionError(f"{what}: the modeled cell allocated, or did not verify")
                runs[mode].update(gates=[round(c[1], 1) for c in watch.calls], variant=variant,
                                  collectives=report.num_collectives, records=len(report.predicted),
                                  modeled=cell, buckets=(nb, nb2), overlap=ddp.overlap_enabled)
                trainer.close()
                del trainer, state, ddp
            total = {k: total[k] + c for k, c in runs["strict"]["launches"].items()}
        if runs["strict"]["launches"] != {k: runs["off"]["launches"][k] + c for k, c in want2.items()}:
            raise AssertionError(f"{what}: launches with the gate {runs['strict']['launches']} against off "
                                 f"{runs['off']['launches']} plus the rebucketed step")
        s, o = runs["strict"], runs["off"]
        cell = s["modeled"]
        # the same cell at the bf16 tensor-core peak (the convolutions' type here)
        bf16_compute = cell.flops_per_step / (PEAK_FLOPS["h100-sxm-bf16"] * 0.3) * 1e3
        window = DEFAULT_TOPOLOGY.overlap_window_frac * bf16_compute if cell.overlap else 0.0
        bf16_ms = bf16_compute + max(0.0, cell.wire_ms - window)
        rows.append((name, cell.modeled_step_ms, bf16_ms, s["ms"]))
        log(f"{what} (overlap {s['overlap']}, {s['buckets'][0]} buckets): gate host ms {s['gates']} (variant "
            f"{s['variant']!r}, then the rebucket's to {s['buckets'][1]} buckets), {s['collectives']} "
            f"collectives, {s['records']} flight records predicted{' = captured' if algo in tan.MODELED_ALGOS else ''}; "
            f"first step {s['first_ms']:.1f} ms strict against {o['first_ms']:.1f} off; then {s['ms']:.2f} "
            f"ms/step strict against {o['ms']:.2f} off; launches equal; planted rejection rolled back; modeled "
            f"{cell.modeled_step_ms:.3f} ms (compute {cell.compute_ms:.3f}, wire {cell.wire_ms:.3f}, exposed "
            f"{cell.exposed_wire_ms:.3f}, {cell.census_wire_bytes} B, {cell.flops_per_step:.4e} FLOPs, legs "
            f"{cell.legs_used}, kernels {cell.kernel_basis['basis']}; at the bf16 peak {bf16_ms:.3f}) against "
            f"{s['ms']:.2f} measured")
    log("[verify] modeled (planner priors, MFU 0.3 of h100-sxm-f32; of h100-sxm-bf16) against measured "
        "ms/step: " + "; ".join(f"{n}: {m:.3f}; {b:.3f} / {t:.2f}" for n, m, b, t in rows))
    return total


#: the controller's α–β legs (s, B/s): the JAX autopilot tests' regime,
#: where a bandwidth collapse makes the int8 ring the cheaper wire
AUTOPILOT_COST = {"flat": (50e-6, 40e9), "qr8": (60e-6, 90e9)}
AUTOPILOT_INCIDENT = {"dominant": "wire_slowdown", "measured_ms": 600.0, "expected_ms": 60.0, "step": 0,
                      "plan_version": 0}


def phase_autopilot(device) -> dict:
    """``[autopilot]`` (see the module docstring).  Returns the launches."""
    from bagua_tpu_torch.autopilot import AutopilotConfig, GangAutopilot
    from bagua_tpu_torch.service.planner import AlphaBeta, CostModel

    what = "[autopilot] VGG16"
    n = RANKS * BATCH_PER_RANK
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(0)
    batch = (torch.rand((n, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device),
             torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device))
    sentinel = RegressionSentinel()
    tel = Telemetry(flight=FlightRecorder(capacity=4096, rank=0, world_size=1), tracing=None, regression=sentinel)
    config = AutopilotConfig(hysteresis_incidents=2, canary_steps=3, cooldown_steps=2, compute_ms=60.0,
                             algorithms=("gradient_allreduce",))
    total = {k: 0 for k in KERNELS}
    int8 = SLICE_PATHS["int8 ring"][1]
    with static_verify("strict"), GateWatch(what) as watch:
        model, params = sb.build("vgg16", torch.bfloat16, device)
        trainer = Trainer(vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                          GradientAllReduceAlgorithm(wire_precision="auto"), group, telemetry=tel,
                          autopilot=lambda ddp: GangAutopilot(
                              ddp, CostModel(**{k: AlphaBeta(*v) for k, v in AUTOPILOT_COST.items()}), config,
                              sentinel=sentinel, telemetry=tel))
        state = trainer.init_state(params)
        del params
        ddp, pilot = trainer.ddp, trainer.autopilot
        nb = ddp.plan.num_buckets
        log_steps = []

        def steps(k, per_bucket, tag):
            nonlocal state
            for _ in range(k):
                reset_launches()
                t0 = time.perf_counter()
                state = trainer.fit(state, [batch])
                torch.cuda.synchronize()
                log_steps.append((tag, round((time.perf_counter() - t0) * 1e3, 1)))
                launches = read_launches()
                want = {kk: nb * per_bucket.get(kk, 0) for kk in KERNELS}
                # the step that demoted runs on the old wire; the tick comes after it
                if launches != want:
                    raise AssertionError(f"{what}, {tag}: launches {launches}, want {want}")
                for kk, c in launches.items():
                    total[kk] += c
                if not torch.isfinite(trainer.losses).all():
                    raise AssertionError(f"{what}: non-finite loss")

        steps(2, {}, "f32")
        # a planted rejection: two wire-dominant incidents, the demotion's
        # re-verification rejected; counted, recorded, nothing dispatched
        sentinel.incidents.extend([dict(AUTOPILOT_INCIDENT, trace_id="tr-planted-1"),
                                   dict(AUTOPILOT_INCIDENT, trace_id="tr-planted-2")])
        watch.reject = True
        steps(1, {}, "f32, rejected demotion")
        watch.reject = False
        rejected = [d for d in pilot.decisions if d["verdict"] == "rejected"]
        if pilot.verifier_rejections != 1 or len(rejected) != 1 or pilot.current_configuration().precision != "f32":
            raise AssertionError(f"{what}: the planted rejection: {pilot.report()}")
        steps(2, {}, "f32 after the rejection")
        # the demotion: re-verified and dispatched on the int8 ring
        sentinel.incidents.extend([dict(AUTOPILOT_INCIDENT, trace_id="tr-wire-1"),
                                   dict(AUTOPILOT_INCIDENT, trace_id="tr-wire-2")])
        gates = len(watch.calls)
        steps(1, {}, "f32, demotes")
        demoted = [d for d in pilot.decisions if d["decision"] == "demote_precision" and d["verdict"] == "canary"]
        if not demoted or pilot.current_configuration().precision != "int8" or len(watch.calls) != gates + 1:
            raise AssertionError(f"{what}: no verified demotion: {pilot.report()}, {len(watch.calls) - gates} gates")
        steps(config.canary_steps, int8, "int8 ring, canary")
        committed = [d for d in pilot.decisions if d["verdict"] in ("committed", "rolled_back")]
        if not committed:
            raise AssertionError(f"{what}: the canary was not adjudicated: {pilot.report()}")
        steps(2, int8 if committed[-1]["verdict"] == "committed" else {}, "after the canary")
        _bitwise_replicas(what, state.params)
        rows = [{k: d[k] for k in ("step", "decision", "verdict", "trace_id", "plan_version")} for d in pilot.decisions]
        gate_ms = [round(c[1], 1) for c in watch.calls]
        trainer.close()
    log(f"{what}, strict gate, Trainer(autopilot=GangAutopilot): decisions {rows}; verifier rejections "
        f"{pilot.verifier_rejections}; gate host ms {gate_ms}; step ms {log_steps}")
    return total


# ---------------------------------------------------------------------------
# [fleet]: the fleet control plane and two gangs at full-width VGG16;
# [sync-bn]: SyncBatchNorm in ResNet; [contrib]: the native stores and the
# IO prefetcher
# ---------------------------------------------------------------------------

#: gang alpha's bucket size, twice the default (the fleet's plan is not the default one)
FLEET_ALPHA_BUCKET = 2 * 10 * 2 ** 20
FLEET_STEPS = 5
FLEET_RDZV = {"min_nodes": 1, "settle_s": 0.05}
FLEET_INCIDENT = {"dominant": "wire_slowdown", "stream": "step_wall", "trace_id": "fleet-beta-regressed"}


def _plan_names(ddp) -> list:
    return [[td.name for td in b] for b in ddp.plan.declarations()]


def _timed_steps(trainer, state, batch, steps, per_bucket, what):
    """``steps`` steps of ``trainer``, each one's launches exact for the
    plan; returns ``(state, ms a step, launches)``."""
    want = {k: steps * trainer.ddp.plan.num_buckets * per_bucket.get(k, 0) for k in KERNELS}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state = trainer.fit(state, itertools.repeat(batch), n_steps=steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = read_launches()
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    if not torch.isfinite(trainer.losses).all():
        raise AssertionError(f"{what}: non-finite loss {trainer.losses.tolist()}")
    _bitwise_replicas(what, state.params)
    return state, ms, launches


#: the scheduler view's fields a restart resets by design: the lease clock,
#: and the incident tier (volatile, like the span and decision tiers) with
#: the verdict it drives
FLEET_VOLATILE = ("lease_remaining_s", "incidents", "last_incident", "regressed", "verdict")


def _durable_view(plane) -> dict:
    """What a restart of the plane must reproduce: the durable dump, the
    plan statuses, each gang's pending directive, and the scheduler view
    but for FLEET_VOLATILE."""
    view = plane.scheduler_view()["gangs"]
    return {"dump": json.dumps(plane.dump(), sort_keys=True), "statuses": plane.plan_statuses(),
            "directives": {g: plane.directive(g) for g in view},
            "view": {g: {k: v for k, v in row.items() if k not in FLEET_VOLATILE} for g, row in view.items()}}


def check_fleet_adoption_on_card(device) -> dict:
    """The small VGG's ByteGrad plan through an in-process fleet plane on the
    card: gang alpha at 2 KiB buckets publishes, gang beta at the default
    size adopts it at step 0 (``adopt_fleet_plan``), and beta's 2 steps
    launch rows 1-3 exactly at the adopted plan's bucket count.  Returns
    the bucket counts and launches."""
    from bagua_tpu_torch.fleet import FleetClient, FleetControlPlane, adopt_fleet_plan, publish_engine_plan
    from bagua_tpu_torch.fleet import start_async_fleet_server

    per_bucket = SLICE_PATHS["ByteGrad"][1]
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = (torch.randn((RANKS * 4, REF_VGG["image_size"], REF_VGG["image_size"], 3), generator=gen, device=device),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 4,), generator=gen, device=device))
    params = module_params(VGG(device=device, **REF_VGG))
    plane = FleetControlPlane(rdzv_kwargs=FLEET_RDZV)
    server = start_async_fleet_server(plane, 0, host="127.0.0.1")
    try:
        fc = FleetClient(f"http://127.0.0.1:{server.server_address[1]}")
        trainers = {}
        for gang, size in (("alpha", 2048), ("beta", None)):
            trainers[gang] = Trainer(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                                     lambda ps: torch.optim.SGD(ps, lr=REF_LR), ByteGradAlgorithm(), group,
                                     bucket_size_bytes=size)
        alpha, beta = trainers["alpha"], trainers["beta"]
        alpha.init_state(tree_map(torch.clone, params))
        state = beta.init_state(tree_map(torch.clone, params))
        fresh = beta.ddp.plan.num_buckets
        if publish_engine_plan(fc, alpha.ddp, meta={"gang": "alpha"}) is None:
            raise AssertionError("fleet on the card: alpha's plan was not published")
        if adopt_fleet_plan(fc, beta.ddp, gang="beta") != "fleet" or \
                _plan_names(beta.ddp) != _plan_names(alpha.ddp) or fresh == beta.ddp.plan.num_buckets:
            raise AssertionError(f"fleet on the card: beta ({fresh} buckets) did not adopt alpha's "
                                 f"{alpha.ddp.plan.num_buckets}")
        nb = beta.ddp.plan.num_buckets
        reset_launches()
        beta.fit(state, itertools.repeat(batch), n_steps=2)
        torch.cuda.synchronize()
        launches = read_launches()
        want = {k: 2 * nb * per_bucket.get(k, 0) for k in KERNELS}
        if launches != want:
            raise AssertionError(f"fleet on the card: beta's launches {launches}, want {want}")
        for trainer in trainers.values():
            trainer.close()
    finally:
        server.shutdown()
        plane.close()
    return {"fresh": fresh, "adopted": nb, "launches": launches}


#: [fleet-gang]: gang beta trains to FLEET_GANG_STEPS with a snapshot every FLEET_GANG_EVERY steps; its
#: first attempt exits hard after step FLEET_GANG_CRASH, once the snapshot before it is complete
FLEET_GANG_STEPS, FLEET_GANG_EVERY, FLEET_GANG_CRASH = 6, 4, 5
FLEET_GANG_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bagua_tpu_torch", "examples",
                                 "fleet_gang.py")


def plan_entry(ddp) -> dict:
    """What [fleet-gang] publishes of gang alpha's plan: its cache key,
    payload, meta and bucket names."""
    from bagua_tpu_torch.fleet import engine_plan_key

    return {"key": engine_plan_key(ddp), "plan": ddp.export_plan_payload(), "names": _plan_names(ddp),
            "meta": {"gang": "alpha", "plan_version": ddp.plan_version}}


def small_vgg_alpha(device):
    """A gang alpha for [fleet-gang]'s small runs: the small VGG's ByteGrad
    engine at 2 KiB buckets on 4 ranks (several buckets, not the default
    plan)."""
    from bagua_tpu_torch.examples import fleet_gang

    params, loss_fn, optimizer, _ = fleet_gang.model_parts("small-vgg", device)
    ddp = DistributedDataParallel(loss_fn, optimizer, ByteGradAlgorithm(), BaguaProcessGroup([device] * RANKS,
                                  intra_size=1), bucket_size_bytes=2048, overlap=True)
    ddp.init(params)
    return ddp


def run_fleet_gang(device, model: str, alpha: dict, W: int, per_bucket: dict) -> dict:
    """Gang beta as W launcher workers (``examples/fleet_gang.py``, ByteGrad
    with overlap) in the beta namespace of a fleet plane in this process,
    which holds gang alpha's published plan (``alpha``: its key, payload,
    meta and bucket names): every process adopts it at step 0, the first
    attempt runs FLEET_GANG_CRASH steps and exits hard, the launcher
    restarts the gang, which resumes from the snapshot at FLEET_GANG_EVERY
    and runs to FLEET_GANG_STEPS.  Then the single controller runs the same
    steps on the plan here.  Raises unless every gate holds; returns the
    readings and the workers' launches summed."""
    from bagua_tpu_torch.examples import fleet_gang
    from bagua_tpu_torch.fleet import FleetClient, FleetControlPlane, gang_endpoint, start_async_fleet_server

    what = f"[fleet-gang] {model} ByteGrad (overlap), W={W}"
    k = RANKS // W
    args = ["--device", device.type, "--model", model, "--algorithm", "bytegrad", "--overlap", "on",
            "--steps", str(FLEET_GANG_STEPS), "--snapshot-every", str(FLEET_GANG_EVERY)]

    @contextlib.contextmanager
    def fleet_try():
        # a fresh plane, snapshot directory and port each try: a try that lost its port may
        # have adopted, snapshotted and reported
        with contextlib.ExitStack() as stack:
            root = tempfile.mkdtemp(prefix="bagua_fleet_gang_")
            stack.callback(shutil.rmtree, root, ignore_errors=True)
            plane = FleetControlPlane(rdzv_kwargs=FLEET_RDZV)
            stack.callback(plane.close)
            server = start_async_fleet_server(plane, 0, host="127.0.0.1")
            stack.callback(server.shutdown)
            base = f"http://127.0.0.1:{server.server_address[1]}"
            fc = FleetClient(base)
            key = fc.publish_plan(plan=alpha["plan"], meta=alpha["meta"], **alpha["key"])
            yield root, plane, base, fc, key

    def command(port, state):
        root, _, base, _, _ = state
        return [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--nproc_per_node", str(W),
                "--max_restarts", "1", "--monitor_interval", "0.2", "--master_port", str(port),
                "--rdzv_endpoint", gang_endpoint(base, "beta"), FLEET_GANG_SCRIPT] + args + [
                "--ranks-per-process", str(k), "--snapshot-dir", os.path.join(root, "snap"), "--fleet", base,
                "--gang", "beta", "--crash", str(FLEET_GANG_CRASH), "--report", os.path.join(root, "beta")]

    run, gang_s, (root, plane, _, fc, key), held = _launch(what, device, command, fleet_try)
    with held:
        if run.returncode != 0:
            raise AssertionError(f"{what}: the launcher exited {run.returncode}:\n{run.stderr[-8000:]}")
        reports = {}
        for name in os.listdir(root):
            if name.startswith("beta.e") and name.endswith(".json"):
                attempt, proc = name[len("beta.e"):-len(".json")].split(".p")
                reports.setdefault(int(attempt), {})[int(proc)] = json.load(open(os.path.join(root, name)))
        if len(reports) != 2 or any(sorted(r) != list(range(W)) for r in reports.values()):
            raise AssertionError(f"{what}: reports of attempts and processes {[sorted(r) for r in reports.values()]}, "
                                 f"want 2 attempts of {W} processes")
        first, second = ([reports[a][p] for p in range(W)] for a in sorted(reports))
        view = plane.scheduler_view()["gangs"]["beta"]
        status = plane.plan_statuses()[key]
        for r in first:
            if not r["adopted"] or r["plan_source"] != "fleet" or r["buckets"] != alpha["names"]:
                raise AssertionError(f"{what}: process {r['process']} did not adopt alpha's plan at step 0 "
                                     f"({r['plan_source']}, {len(r['buckets'])} buckets)")
        for r in second:
            if r["resumed_from"] != FLEET_GANG_EVERY or r["plan_source"] != "carried" or \
                    r["buckets"] != alpha["names"] or r["exit"] != "done":
                raise AssertionError(f"{what}: process {r['process']} resumed from {r['resumed_from']} "
                                     f"({r['plan_source']}, exit {r['exit']}), want step {FLEET_GANG_EVERY}, carried")
        if view["ranks_reporting"] != W or status["adopters"] != {"beta": alpha["meta"]["plan_version"]} or \
                status["cohort"] != ["beta"]:
            raise AssertionError(f"{what}: the plane's view {view['ranks_reporting']} ranks reporting, "
                                 f"adopters {status['adopters']}, cohort {status['cohort']}")
        nb = len(alpha["names"])
        total = {}
        for reps, steps in ((first, FLEET_GANG_CRASH), (second, FLEET_GANG_STEPS - FLEET_GANG_EVERY)):
            for r in reps:
                if [s["step"] for s in r["steps"]] != list(range(r["steps"][0]["step"], r["steps"][0]["step"] + steps)):
                    raise AssertionError(f"{what}: process {r['process']} ran steps {[s['step'] for s in r['steps']]}")
                for kernel, n in r["launches"].items():
                    total[kernel] = total.get(kernel, 0) + n
                if device.type != "cuda":
                    continue
                want = {kernel: steps * nb * per_bucket.get(kernel, 0) for kernel in r["launches"]}
                unheld = [kernel for kernel in per_bucket if not r["held"].get(kernel, {}).get("bitwise")]
                if r["launches"] != want or unheld:
                    raise AssertionError(f"{what}: process {r['process']} launched {r['launches']} (want {want}); "
                                         f"first launches not bitwise their plain versions: {unheld}")
        # the single controller: the same steps on the plan (a read-only lookup) at the same snapshot
        # cadence, cuDNN as the workers
        gc.collect()
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            ref = fleet_gang.run(BaguaProcessGroup([device] * RANKS, intra_size=1),
                                 fleet_gang.parse_args(args + ["--snapshot-dir", os.path.join(root, "ref")]), fleet=fc)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    if not ref["adopted"] or ref["buckets"] != alpha["names"]:
        raise AssertionError(f"{what}: the single controller did not run alpha's plan")
    want_losses = {s["step"]: s["losses"] for s in ref["steps"]}
    for reps in (first, second):
        for i in range(len(reps[0]["steps"])):
            step = reps[0]["steps"][i]["step"]
            if [x for r in reps for x in r["steps"][i]["losses"]] != want_losses[step]:
                raise AssertionError(f"{what}: step {step}'s losses "
                                     f"{[x for r in reps for x in r['steps'][i]['losses']]} differ from the "
                                     f"single controller's {want_losses[step]}")
    if [d for r in second for d in r["digests"]] != ref["digests"]:
        raise AssertionError(f"{what}: the final parameters differ from the single controller's")
    # both sides' timed steps are the first attempt's after its first (steps 2 to FLEET_GANG_CRASH), the
    # step that ran beside the snapshot's writer among them
    timed = slice(1, FLEET_GANG_CRASH)
    gang_ms, ref_ms = [s["ms"] for s in first[0]["steps"][timed]], [s["ms"] for s in ref["steps"][timed]]
    return {"W": W, "k": k, "gang_s": gang_s, "buckets": nb,
            "step_ms": [s["ms"] for s in first[0]["steps"]], "ref_step_ms": [s["ms"] for s in ref["steps"]],
            "ms": statistics.median(gang_ms), "ref_ms": statistics.median(ref_ms),
            "mean_ms": statistics.fmean(gang_ms), "ref_mean_ms": statistics.fmean(ref_ms),
            "writer_steps": {side: {s["step"]: s["ms"] for s in steps if s["writer_busy"]}
                             for side, steps in (("gang", first[0]["steps"]), ("single", ref["steps"]))},
            "pinned": {side: [s["pinned"] for s in steps]
                       for side, steps in (("gang", first[0]["steps"]), ("single", ref["steps"]))},
            "adopt_ms": [r["adopt_ms"] for r in first],
            "resume_ms": [r["resume_ms"] for r in second], "resume_bytes": second[0]["resume_bytes"],
            "launches": total, "first_launches": first[0]["launches"], "second_launches": second[0]["launches"],
            "held": {kernel: h["max_abs_err"] for kernel, h in first[0]["held"].items()}}


def phase_fleet_gang(device, smi: str, alpha: dict) -> dict:
    """``[fleet-gang]`` (see the module docstring) on ``alpha``, the plan
    ``[fleet]`` published.  Returns the launches."""
    cards = torch.cuda.device_count()
    W = max(w for w in (4, 2, 1) if w <= cards and RANKS % w == 0)
    got = run_fleet_gang(device, "vgg16", alpha, W, SLICE_PATHS["ByteGrad"][1])
    log(f"[fleet-gang] VGG16 bf16 ByteGrad (overlap), gang beta as {W} launcher worker(s) x {got['k']} ranks in "
        f"the fleet's beta namespace (NCCL; "
        f"{got['gang_s']:.1f} s with the restart): every process adopted alpha's tuned plan at step 0 "
        f"({got['buckets']} buckets) in {[round(ms, 1) for ms in got['adopt_ms']]} ms; "
        f"{FLEET_GANG_CRASH} steps; steps 2-{FLEET_GANG_CRASH} against the single controller's at the same "
        f"snapshot cadence: median {got['ms']:.2f} / {got['ref_ms']:.2f} ms (ratio {got['ms'] / got['ref_ms']:.3f}), "
        f"mean {got['mean_ms']:.2f} / {got['ref_mean_ms']:.2f} ms (ratio {got['mean_ms'] / got['ref_mean_ms']:.3f}); "
        f"steps {[round(ms, 1) for ms in got['step_ms']]} ms, the single controller's "
        f"{[round(ms, 1) for ms in got['ref_step_ms']]}; the steps that started with the snapshot's writer busy "
        f"(step: ms) {got['writer_steps']}, the pinned host allocator's growth during each step "
        f"([cudaHostAlloc calls, us]) {got['pinned']}; the first attempt exited hard after step {FLEET_GANG_CRASH}, "
        f"the launcher restarted the gang, which resumed from step {FLEET_GANG_EVERY} in "
        f"{[round(ms, 1) for ms in got['resume_ms']]} ms ({got['resume_bytes']} B read by each process, the plan "
        f"carried) and ran to step {FLEET_GANG_STEPS}; launches per process {got['first_launches']} then "
        f"{got['second_launches']}, first launches bitwise their plain versions (max abs err {got['held']}); every "
        f"step's losses and the final parameters bitwise the single controller's; the plane's scheduler view "
        f"saw {W} process(es) reporting and beta once among the plan's adopters; {smi}")
    return got["launches"]


def _tensor_bytes() -> int:
    """The card memory tensors hold, garbage collected first: cuBLAS's
    workspaces (one a stream the engines ran a GEMM on, kept by PyTorch for
    the process's life) are released before the reading."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def phase_fleet(device) -> tuple:
    """``[fleet]`` (see the module docstring).  Returns the launches and
    gang alpha's published plan (:func:`plan_entry`), which ``[fleet-gang]``
    publishes again."""
    from bagua_tpu_torch.ddp import AutotuneSession
    from bagua_tpu_torch.fleet import (
        FleetClient, FleetControlPlane, engine_plan_key, gang_endpoint, publish_engine_plan,
        start_async_fleet_server,
    )
    from bagua_tpu_torch.observability.aggregate import StepSummary, gang_kv_key
    from bagua_tpu_torch.perflab import FleetConfig, Straggler, run_fleet
    from bagua_tpu_torch.resilience import ElasticResumeCoordinator

    what = "[fleet] VGG16 ByteGrad (overlap)"
    per_bucket = SLICE_PATHS["ByteGrad"][1]
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    n = RANKS * BATCH_PER_RANK
    mem0 = _tensor_bytes()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="bagua_fleet_")
    wal_dir = os.path.join(root, "wal")
    plane = FleetControlPlane(wal_dir=wal_dir, rdzv_kwargs=FLEET_RDZV, autotune_kwargs=dict(
        max_samples=AUTOTUNE_STEPS, sampling_confidence_time_s=0.0, warmup_time_s=0.0))
    servers = [start_async_fleet_server(plane, 0, host="127.0.0.1")]
    total = {k: 0 for k in KERNELS}

    def add(launches):
        for k, c in launches.items():
            total[k] += c

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.01, momentum=0.9)

    try:
        fc = FleetClient(f"http://127.0.0.1:{servers[0].server_address[1]}")
        gen = torch.Generator(device=device).manual_seed(0)
        batch = (torch.rand((n, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device),
                 torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device))
        # gang alpha: tuned by its namespace's autotune service, then publishes
        model, params = sb.build("vgg16", torch.bfloat16, device)
        alpha = Trainer(vgg_loss_fn(model), sgd, build_algorithm("bytegrad"), group,
                        bucket_size_bytes=FLEET_ALPHA_BUCKET)
        state = alpha.init_state(params)
        del params
        if not alpha.ddp.overlap_enabled:
            raise AssertionError(f"{what}: the engine resolved overlap off")
        alpha._session = AutotuneSession(alpha.ddp, "vgg16", client=fc.autotune_client("alpha"), interval=2)
        state, tuned, versions, alpha_buckets = _autotune(alpha, state, batch, per_bucket, f"{what}, gang alpha")
        add(tuned)
        if plane.gang("alpha").autotune_models != ["vgg16"]:
            raise AssertionError(f"{what}: alpha's session did not reach its namespace's autotune service")
        alpha._session = None  # the tuned plan stands while it is timed and published
        state, alpha_ms, launches = _timed_steps(alpha, state, batch, FLEET_STEPS, per_bucket, f"{what}, alpha")
        add(launches)
        alpha_plan_version = alpha.ddp.plan_version
        key = publish_engine_plan(fc, alpha.ddp, meta={"gang": "alpha", "plan_version": alpha_plan_version})
        alpha_names = _plan_names(alpha.ddp)
        alpha_entry = plan_entry(alpha.ddp)
        if key is None or plane.plan_count() != 1:
            raise AssertionError(f"{what}: alpha's plan was not published ({key})")
        alpha.close()
        del alpha, state, model
        gc.collect()
        # gang beta: a fresh Trainer at the default size adopts alpha's plan at step 0
        jsonl = os.path.join(root, "beta.jsonl")
        tel = Telemetry(metrics_jsonl=jsonl, flight=None, tracing=None, regression=None)
        model, params = sb.build("vgg16", torch.bfloat16, device)
        beta = Trainer(vgg_loss_fn(model), sgd, build_algorithm("bytegrad"), group, telemetry=tel)
        state = beta.init_state(params)
        del params
        fresh_buckets = beta.ddp.plan.num_buckets
        if _plan_names(beta.ddp) == alpha_names:
            raise AssertionError(f"{what}: beta's fresh plan is alpha's already; the adoption would test nothing")
        plan_key = engine_plan_key(beta.ddp)
        coordinator = ElasticResumeCoordinator(
            os.path.join(root, "beta_snapshots"), telemetry=tel,
            fleet_plan_fn=lambda: (fc.lookup_plan(gang="beta", **plan_key) or {}).get("plan"),
            fleet_directive_fn=lambda: fc.gang_directive("beta"))
        version0 = beta.ddp.plan_version
        t0 = time.perf_counter()
        source = coordinator.fleet_warm_start(beta.ddp)
        adopt_ms = (time.perf_counter() - t0) * 1e3
        if source != "fleet" or _plan_names(beta.ddp) != alpha_names or beta.ddp.plan_version != version0 + 1:
            raise AssertionError(f"{what}: beta's warm start {source!r}, plan version {version0} -> "
                                 f"{beta.ddp.plan_version}, buckets equal alpha's: "
                                 f"{_plan_names(beta.ddp) == alpha_names}")
        state, beta_first_ms, launches = _timed_steps(beta, state, batch, 1, per_bucket, f"{what}, beta's first step")
        add(launches)
        state, beta_ms, launches = _timed_steps(beta, state, batch, FLEET_STEPS, per_bucket, f"{what}, beta")
        add(launches)
        beta_buckets = beta.ddp.plan.num_buckets
        beta.close()
        tel.close()
        restarts = [json.loads(line) for line in open(jsonl) if '"restart"' in line]
        if validate_metrics_file(jsonl) or [(r["step"], r["plan_source"]) for r in restarts] != [(0, "fleet")]:
            raise AssertionError(f"{what}: beta's restart events {restarts}")
        del beta, state, model
        gc.collect()
        # the incidents that cite the plan: quarantine, and beta's rollback directive
        fc.rendezvous_client("beta", node_rank=0).kv_set(
            gang_kv_key("0", 0), StepSummary(rank=0, step=FLEET_STEPS, p50_ms=beta_ms).payload())
        fc.push_incidents("beta", [dict(FLEET_INCIDENT, step=FLEET_STEPS, plan_version=alpha_plan_version)])
        summary = fc.remediate()
        directive = coordinator.fleet_directive()
        if (summary.get("quarantined") != [key] or not directive or directive["action"] != "rollback_plan"
                or directive["detail"]["cache_key"] != key):
            raise AssertionError(f"{what}: remediation {summary}, beta's directive {directive}")
        if not fc.ack_directive("beta", directive["id"]) or coordinator.fleet_directive() is not None:
            raise AssertionError(f"{what}: beta's ack of directive {directive['id']} did not clear it")
        # a restart of the plane on the same WAL
        before = _durable_view(plane)
        servers.pop().shutdown()
        plane.close()
        t0 = time.perf_counter()
        plane = FleetControlPlane(wal_dir=wal_dir, rdzv_kwargs=FLEET_RDZV)
        replay_ms = (time.perf_counter() - t0) * 1e3
        after = _durable_view(plane)
        if after != before:
            raise AssertionError(f"{what}: the replayed plane differs: {before} against {after}")
        servers.append(start_async_fleet_server(plane, 0, host="127.0.0.1"))
        base = f"http://127.0.0.1:{servers[0].server_address[1]}"
        fc = FleetClient(base)
        if fc.lookup_plan(gang="gamma", **plan_key) is not None:
            raise AssertionError(f"{what}: a third gang was served the quarantined plan")
        # the fleet simulator through the plane's namespaces
        fault = Straggler(gang=1, rank=3, factor=3.0, phase="wire")
        cfg = FleetConfig(n_gangs=2, ranks_per_gang=4, windows=3, seed=11, faults=(fault,))
        report = run_fleet(cfg, gang_endpoint=lambda g: gang_endpoint(base, f"sim-{g}"))
        detections = report["gangs"][1]["straggler_detections"]
        if (report["gangs"][0]["straggler_detections"] or len(detections) != cfg.windows
                or any((d["rank"], d["phase"]) != (3, "wire") for d in detections)):
            raise AssertionError(f"{what}: run_fleet flagged {report['gangs']}")
        del batch
        workspaces = torch.cuda.memory_allocated()
        left = _tensor_bytes()
        workspaces -= left
        if left != mem0:
            raise AssertionError(f"{what}: {left - mem0} B of card memory left allocated")
    finally:
        for server in servers:
            server.shutdown()
        plane.close()
        shutil.rmtree(root, ignore_errors=True)
    log(f"{what}, {RANKS} ranks x {BATCH_PER_RANK}: gang alpha at {FLEET_ALPHA_BUCKET} B buckets, tuned by its "
        f"namespace's autotune service (plan version {versions[0]} -> {versions[1]}, buckets {alpha_buckets}), "
        f"{alpha_ms:.2f} ms/step; published {key}; gang beta (fresh plan {fresh_buckets} buckets) adopted it "
        f"at step 0 in {adopt_ms:.1f} ms (one rebucket, plan_source=fleet), {beta_buckets} buckets equal "
        f"alpha's, its first step {beta_first_ms:.1f} ms, then {beta_ms:.2f} ms/step against alpha's {alpha_ms:.2f}, "
        f"launches exact; the incident quarantined "
        f"the plan, beta's rollback_plan directive acked; the WAL replayed in {replay_ms:.1f} ms to the same "
        f"dump, statuses, directives and scheduler view (but {', '.join(FLEET_VOLATILE)}), a third gang "
        f"refused the plan; run_fleet flagged rank 3 "
        f"(wire) in {len(detections)} of {cfg.windows} windows; phase {time.perf_counter() - t_phase:.1f} s, "
        f"card memory held by tensors as before ({workspaces} B of cuBLAS workspaces released)")
    return total, alpha_entry


#: the sync-BN phase: the statistics' collectives a ResNet-50 step, one a norm (its mean and mean of squares
#: stacked)
RESNET50_NORMS = 53


def _sync_resnet_pass(device, dtype, variables, x, y):
    """The small ResNet with ``sync_bn=True`` over RANKS rank-stacked copies
    under a ``vmap`` over the ranks on ``device``: the losses, the
    gradients (``batch_stats`` left out) and each norm's statistics as the
    ranks hold them."""
    from bagua_tpu_torch.contrib.sync_batchnorm import statistics_sink
    from bagua_tpu_torch.models._rank_ops import over_ranks

    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    model = ResNet(SMALL_RESNET_STAGES, SMALL_RESNET_CLASSES, dtype, sync_bn=True, device=device)
    stacked = tree_map(lambda t: t.to(device, dtype).expand(RANKS, *t.shape).clone().requires_grad_(True), variables)
    loss_fn = resnet_loss_fn(model)

    def one_rank(v, xr, yr):
        sink = []
        with statistics_sink(sink):
            loss = loss_fn(v, (xr, yr))
        return loss, [t for st in sink for t in st]

    with over_ranks(group):
        losses, stats = torch.func.vmap(one_rank)(stacked, x.to(device, dtype), y.to(device))
    losses.sum().backward()
    grads = [leaf.grad.cpu() for name, leaf in tree_flatten_with_names(stacked) if "batch_stats" not in name]
    return losses.detach().cpu(), grads, [t.detach().cpu() for t in stats]


def _sync_resnet_steps(device, variables, x, y):
    """SMALL_RESNET_STEPS f32 ``gradient_allreduce`` engine steps of the
    small ResNet with ``sync_bn=True`` (SGD 0.005 momentum 0.9): the last
    losses, and the starting and final parameters as CPU f64 leaves."""
    model = ResNet(SMALL_RESNET_STAGES, SMALL_RESNET_CLASSES, torch.float32, sync_bn=True, device=device)
    ddp = DistributedDataParallel(
        resnet_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=SMALL_RESNET_LR, momentum=0.9),
        GradientAllReduceAlgorithm(), BaguaProcessGroup([device] * RANKS, intra_size=1),
        dp_filter=lambda name: "batch_stats" not in name)
    state = ddp.init(tree_map(lambda t: t.to(device), variables))
    start = [leaf.detach().double().cpu() for leaf in tree_leaves(state.params)]
    batch = (x.reshape(-1, *x.shape[2:]).to(device, torch.float32), y.reshape(-1).to(device))
    for _ in range(SMALL_RESNET_STEPS):
        state, losses = ddp.train_step(state, batch)
    ddp.shutdown()
    return losses.detach().double().cpu(), start, [leaf.detach().double().cpu() for leaf in tree_leaves(state.params)]


def check_sync_resnet_on_card(device) -> dict:
    """The small ResNet with ``sync_bn=True`` on the card against the CPU:
    f64 losses and gradients under a ``vmap`` over RANKS ranks (rtol 1e-12,
    1e-9 of each leaf's largest value), every norm's statistics the same on
    every rank (bitwise) and within 1e-12 of the CPU's; then
    SMALL_RESNET_STEPS f32 ``gradient_allreduce`` engine steps, TF32 off
    and cuDNN deterministic, each leaf within SMALL_RESNET_SHARE of the
    CPU run's move and the losses within SMALL_RESNET_LOSS_RTOL.  Raises on
    a miss; returns the readings."""
    variables, x, y = _small_resnet_data(8)
    card_losses, card, card_stats = _sync_resnet_pass(device, torch.float64, variables, x, y)
    cpu_losses, cpu, cpu_stats = _sync_resnet_pass(torch.device("cpu"), torch.float64, variables, x, y)
    grad_err = max(abs_err(a, b) / max(float(b.abs().max()), 1e-300) for a, b in zip(card, cpu))
    stat_err = max(abs_err(a, b) / max(float(b.abs().max()), 1e-300) for a, b in zip(card_stats, cpu_stats))
    if not torch.allclose(card_losses, cpu_losses, rtol=1e-12, atol=0) or grad_err > 1e-9 or stat_err > 1e-12:
        raise AssertionError(f"[sync-bn] small ResNet card vs CPU (f64): losses {card_losses.tolist()} vs "
                             f"{cpu_losses.tolist()}, gradients {grad_err:.3e}, statistics {stat_err:.3e}")
    if len(card_stats) != 2 * 17 or any(not torch.equal(t, t[:1].expand_as(t)) for t in card_stats):
        raise AssertionError(f"[sync-bn] small ResNet: {len(card_stats)} statistics, not the same on every rank")
    variables, x, y = _small_resnet_data(SMALL_RESNET_BATCH)
    with _deterministic(), _no_tf32():
        card_losses, card_start, card = _sync_resnet_steps(device, variables, x, y)
    cpu_losses, cpu_start, cpu = _sync_resnet_steps(torch.device("cpu"), variables, x, y)
    readings = {"grad_err": grad_err, "stat_err": stat_err, "vs_cpu": share_of_move(card, cpu, cpu_start),
                "loss_rtol": float(((card_losses - cpu_losses).abs() / cpu_losses.abs()).max())}
    if readings["vs_cpu"] > SMALL_RESNET_SHARE or readings["loss_rtol"] > SMALL_RESNET_LOSS_RTOL:
        raise AssertionError(f"[sync-bn] small ResNet f32 engine steps, card vs CPU: {readings}")
    return readings


def phase_sync_bn(device, profile: bool = False) -> dict:
    """``[sync-bn]`` (see the module docstring); ``--profile`` traces one
    more step of each.  No kernel runs."""
    from bagua_tpu_torch.contrib import sync_batchnorm
    from bagua_tpu_torch.models.resnet import init_resnet50

    reset_launches()
    r = check_sync_resnet_on_card(device)
    log(f"[sync-bn] small ResNet [1,1,1,1] sync_bn=True: f64 losses and gradients under vmap, {RANKS} ranks x 8, "
        f"card within {r['grad_err']:.2e} of the CPU (of each leaf's scale), the 34 statistics the same on every "
        f"rank and within {r['stat_err']:.2e} of the CPU's; {SMALL_RESNET_STEPS} f32 gradient_allreduce engine "
        f"steps, {RANKS} ranks x {SMALL_RESNET_BATCH}: card within {r['vs_cpu']:.3e} of the CPU's move (bound "
        f"{SMALL_RESNET_SHARE}), losses within rtol {r['loss_rtol']:.2e}")
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    n = RANKS * BATCH_PER_RANK
    rows = {}
    for sync in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(0)
        model, variables = init_resnet50(gen, IMAGE_SIZE, imagenet.CLASSES, compute_dtype=torch.bfloat16,
                                         sync_bn=sync, device=device)
        ddp = DistributedDataParallel(resnet_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.005, momentum=0.9),
                                      GradientAllReduceAlgorithm(), group,
                                      dp_filter=lambda name: "batch_stats" not in name)
        state = ddp.init(variables)
        del variables
        batch = (torch.rand(n, IMAGE_SIZE, IMAGE_SIZE, 3, device=device, generator=gen),
                 torch.randint(0, imagenet.CLASSES, (n,), device=device, generator=gen, dtype=torch.int32))
        seconds, calls = [], []
        real = sync_batchnorm.allreduce

        def counted(*args, **kwargs):
            calls.append(args[0].shape)
            return real(*args, **kwargs)

        sync_batchnorm.allreduce = counted
        try:
            for _ in range(RESNET_STEPS):
                calls.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, losses = ddp.train_step(state, batch)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                per_step = len(calls)
        finally:
            sync_batchnorm.allreduce = real
        if not torch.isfinite(losses).all():
            raise AssertionError(f"[sync-bn] ResNet-50 sync_bn={sync}: non-finite losses {losses.tolist()}")
        if per_step != (RESNET50_NORMS if sync else 0) or any(c[:2] != (RANKS, 2) for c in calls):
            raise AssertionError(f"[sync-bn] ResNet-50 sync_bn={sync}: {per_step} statistics collectives a step")
        _bitwise_replicas(f"[sync-bn] ResNet-50 sync_bn={sync}", state.params)
        timed = seconds[RESNET_WARMUP:]
        rows[sync] = (statistics.mean(timed) * 1e3, n / statistics.mean(timed),
                      torch.cuda.max_memory_allocated() / 2 ** 30, per_step, [round(t * 1e3, 1) for t in timed])
        if profile:
            profile_step(f"ResNet-50 gradient_allreduce sync_bn={sync}", lambda: ddp.train_step(state, batch))
        ddp.shutdown()
        del ddp, state, batch, model
    for sync, (ms, ips, peak, per_step, each) in rows.items():
        log(f"[sync-bn] ResNet-50 {IMAGE_SIZE}x{IMAGE_SIZE} bf16, {RANKS} ranks x {BATCH_PER_RANK}, "
            f"gradient_allreduce, sync_bn={sync}: {ms:.1f} ms/step over {len(each)} steps (each {each}), "
            f"{ips:.1f} img/s on the card, peak memory {peak:.2f} GiB, {per_step} statistics collectives a step")
    log(f"[sync-bn] sync_bn=True against False: {rows[True][0] / rows[False][0]:.4f} of the step time")
    return _no_launches("[sync-bn]")


#: the prefetcher's files: count and the largest size in bytes
CONTRIB_FILES, CONTRIB_FILE_BYTES = 300, 1 << 16
CONTRIB_SHM_BYTES = 256 * 2 ** 20


def _shm_child(name: str, queue) -> None:
    """``[contrib]``'s ``spawn`` child: reads the parent's value from the
    segment and writes one back."""
    from bagua_tpu_torch.contrib import ShmStore

    try:
        store = ShmStore(name=name, capacity_bytes=1 << 20, create=False)
        queue.put(("ok", store.get("from_parent")))
        store.set("from_child", {"pid": os.getpid()})
        store.shutdown()
    except Exception as e:  # the parent raises on it
        queue.put(("err", repr(e)))


def phase_contrib(device) -> dict:
    """``[contrib]`` (see the module docstring).  No kernel runs."""
    import multiprocessing

    from bagua_tpu_torch.contrib import (
        CachedDataset, IOPrefetcher, RendezvousStore, ShmStore, make_rendezvous_cluster_store,
    )
    from bagua_tpu_torch.distributed.rendezvous import RendezvousState, start_rendezvous_server
    from bagua_tpu_torch.models.resnet import init_resnet50

    reset_launches()
    t_phase = time.perf_counter()
    # the shm store: the parent writes, a spawned process reads and writes back
    name = f"/bagua_smoke_{os.getpid()}"
    store = ShmStore(name=name, capacity_bytes=1 << 20)
    try:
        store.clear()
        value = {"array": np.arange(1000, dtype=np.float32), "label": 7}
        store.set("from_parent", value)
        ctx = multiprocessing.get_context("spawn")
        queue = ctx.Queue()
        child = ctx.Process(target=_shm_child, args=(name, queue))
        child.start()
        try:
            status, got = queue.get(timeout=120)
        finally:
            child.join(timeout=60)
            if child.is_alive():
                child.kill()
        if status != "ok" or not np.array_equal(got["array"], value["array"]) or got["label"] != 7:
            raise AssertionError(f"[contrib] shm: the child read {status} {got!r}")
        if store.get("from_child") != {"pid": child.pid} or store.num_keys() != 2:
            raise AssertionError(f"[contrib] shm: the child's write {store.get('from_child')!r}")
    finally:
        store.shutdown()
        ShmStore(name=name, capacity_bytes=1 << 20).unlink()
    # the rendezvous store against two live servers
    servers = [start_rendezvous_server(RendezvousState(max_blob_bytes=1 << 24), 0, host="127.0.0.1")
               for _ in range(2)]
    try:
        endpoints = [f"127.0.0.1:{s.server_address[1]}" for s in servers]
        single = RendezvousStore(endpoints[0])
        single.set("sample/0", (np.arange(10), {"label": 3}))
        arr, meta = single.get("sample/0")
        if not np.array_equal(arr, np.arange(10)) or meta != {"label": 3} or single.num_keys() != 1:
            raise AssertionError("[contrib] rendezvous store: round trip")
        single.clear()
        cluster = make_rendezvous_cluster_store(endpoints)
        items = {f"k{i}": np.full(4, i) for i in range(64)}
        cluster.mset(items)
        counts = [RendezvousStore(e).num_keys() for e in endpoints]
        if any(not np.array_equal(cluster.get(k), v) for k, v in items.items()) or sum(counts) != 64 \
                or min(counts) == 0:
            raise AssertionError(f"[contrib] rendezvous cluster store: keys a server {counts}")
    finally:
        for s in servers:
            s.shutdown()
    # the IO prefetcher streams generated files in order
    root = tempfile.mkdtemp(prefix="bagua_contrib_")
    try:
        rng = np.random.RandomState(0)
        paths = []
        for i in range(CONTRIB_FILES):
            path = os.path.join(root, f"f{i:04d}.bin")
            with open(path, "wb") as f:
                f.write(rng.bytes(int(rng.randint(1, CONTRIB_FILE_BYTES))))
            paths.append(path)
        pf = IOPrefetcher(n_threads=8)
        try:
            t0 = time.perf_counter()
            stream = list(pf.read_ordered(paths))
            read_ms = (time.perf_counter() - t0) * 1e3
        finally:
            pf.close()
        n_bytes = sum(len(p) for _, p in stream if p is not None)
        if [p for p, _ in stream] != paths or any(payload != open(p, "rb").read() for p, payload in stream):
            raise AssertionError("[contrib] the prefetcher's stream differs from the files")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the cached dataset on the shm backend feeds ResNet-50 with sync_bn=True
    n = RANKS * BATCH_PER_RANK
    data = imagenet.SyntheticImageNet(n=n, image_size=IMAGE_SIZE)
    shm_name = f"/bagua_smoke_cache_{os.getpid()}"
    shm = CachedDataset(data, backend="shm", name=shm_name, capacity_bytes=CONTRIB_SHM_BYTES)
    memory = CachedDataset(data, backend="memory")
    try:
        shm.cache_loader.store.clear()
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device=device).manual_seed(0)
        model, variables = init_resnet50(gen, IMAGE_SIZE, imagenet.CLASSES, compute_dtype=torch.bfloat16,
                                         sync_bn=True, device=device)
        ddp = DistributedDataParallel(resnet_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.005, momentum=0.9),
                                      GradientAllReduceAlgorithm(), BaguaProcessGroup([device] * RANKS, intra_size=1),
                                      dp_filter=lambda name: "batch_stats" not in name)
        state = ddp.init(variables)
        del variables
        for step in range(2):
            order = np.random.RandomState(step).permutation(n)
            got = [shm[int(i)] for i in order]
            want = [memory[int(i)] for i in order]
            if any(not np.array_equal(g[0], w[0]) or g[1] != w[1] for g, w in zip(got, want)):
                raise AssertionError(f"[contrib] step {step}: the shm backend's batch differs from the memory one's")
            x = torch.from_numpy(np.stack([s[0] for s in got])).to(device)
            y = torch.from_numpy(np.array([s[1] for s in got], np.int32)).to(device)
            state, losses = ddp.train_step(state, (x, y))
            if not torch.isfinite(losses).all():
                raise AssertionError(f"[contrib] ResNet-50 step {step}: non-finite losses {losses.tolist()}")
        hits = (shm.cache_loader.hit_rate, memory.cache_loader.hit_rate)
        if hits[0] != hits[1] or shm.cache_loader.num_keys() != n:
            raise AssertionError(f"[contrib] cache hit rates {hits}, {shm.cache_loader.num_keys()} keys in the segment")
        ddp.shutdown()
        del ddp, state, model
    finally:
        shm.cache_loader.store.shutdown()
        ShmStore(name=shm_name, capacity_bytes=CONTRIB_SHM_BYTES).unlink()
    log(f"[contrib] shm store written by this process and read by a spawned one; the rendezvous store and a "
        f"two-server cluster ({counts} keys a server) round trip; the IO prefetcher streamed {CONTRIB_FILES} "
        f"files ({n_bytes} B) in order in {read_ms:.1f} ms; CachedDataset on the shm backend fed 2 ResNet-50 "
        f"sync_bn=True steps ({RANKS} ranks x {BATCH_PER_RANK}, {IMAGE_SIZE}x{IMAGE_SIZE}) with batches bitwise "
        f"the memory backend's (hit rate {hits[0]:.2f}); phase {time.perf_counter() - t_phase:.1f} s")
    return _no_launches("[contrib]")


#: [dist]: the gang's wires on VGG16, each run in turn by the same workers:
#: name -> (algorithm, its arguments, overlap, launches per step and bucket,
#: the first steps that launch none: QAdam's warm-up, which the gang's
#: warm-up steps then take in, so that they hold its first launches)
DIST_CASES = {
    "f32": ("gradient_allreduce", {}, "auto", {}, 0),
    "ByteGrad": ("bytegrad", {}, "on", SLICE_PATHS["ByteGrad"][1], 0),
    "int8 ring": ("gradient_allreduce", {"wire_precision": "int8"}, "auto", SLICE_PATHS["int8 ring"][1], 0),
    "ZeRO int8 ring": ("zero", {"wire_precision": "int8"}, "auto", ZERO_PATHS["ZeRO int8 ring"][2], 0),
    "decentralized shift_one": ("decentralized", {"peer_selection_mode": "shift_one"}, "off",
                                DP_PATHS["decentralized shift_one"][3], 0),
    "low-precision decentralized": ("low_precision_decentralized", {}, "off",
                                    DP_PATHS["low-precision decentralized"][3], 0),
    "QAdam": ("qadam", {"optimizer": QADAM_FULL}, "off", DP_PATHS["QAdam"][3], QADAM_FULL["warmup_steps"]),
}
DIST_WARMUP, DIST_STEPS = 1, 5
#: [dist]'s twin paths, each a launcher gang against the single controller:
#: name -> (examples/gang.py model, mesh, case, warm-up steps); DIST_STEPS
#: timed steps follow.  Path (b) is [mesh-engine]'s MESH_OBS_PATH case
#: (the same flags, seed-0 weights and batches, GPT_WARMUP + GPT_STEPS
#: steps), whose run there is its single-controller reference
DIST_PATH_B = "path (b): GPT-2 small engine, dp 4 x tp 2 gradient_allreduce (overlap)"
DIST_TWINS = {
    "path (a): Llama 7B width, tp 2 x sp 2 zigzag, fused tp": (
        "llama-7b", {"dp": 1, "tp": 2, "sp": 2}, ["stacked", {"tp_fused": True}, "auto"], DIST_WARMUP),
    DIST_PATH_B: ("gpt2-small", {"dp": 4, "tp": 2}, ["gradient_allreduce", {"blocks_per_stage": 12}, "auto"],
                  GPT_WARMUP),
}
#: single-controller reports of DIST_TWINS paths made by an earlier phase
#: (``gang.run_case``'s keys: digests, ms_per_step, launches, losses)
DIST_REFERENCES = {}
#: a fused path's first step against the unfused model's: [slice] path
#: (a)'s contract (f32 sums of the same products in another order)
FUSED_LOSS_RTOL = 1e-5
#: the kernels a twin path holds against its plain version within a
#: tolerance (rows 6-9)
TWIN_KERNELS = ("block_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "matmul_tile")
DIST_TIMEOUT_S = 600
GANG_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bagua_tpu_torch", "examples", "gang.py")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


#: launcher runs made again, each on a fresh port, where another process took
#: the run's port between _free_port() and the bind (or the launcher's
#: restart's port + 1)
PORT_RETRIES = 2


def _launch(what: str, device, command, setup=contextlib.nullcontext):
    """Runs the launcher's ``command(port, state)`` from the repo, with
    ``state`` what ``setup()`` yields on entry and ``port`` from
    _free_port().  Where it failed for an address in use (another process
    took the port, or the restart's port + 1), it prints the retry on a
    line of its own, leaves that try's ``setup()`` and runs again with a
    fresh port and a fresh ``setup()``, at most PORT_RETRIES times.
    Returns the last run, its seconds, its state and an ExitStack that
    holds its ``setup()`` open for the caller to close."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([repo] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    for retry in range(PORT_RETRIES + 1):
        with contextlib.ExitStack() as stack:
            state = stack.enter_context(setup())
            port = _free_port()
            cmd = command(port, state)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            run = subprocess.run(cmd, env=env, cwd=repo, capture_output=True, text=True, timeout=DIST_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            lost = run.returncode != 0 and ("EADDRINUSE" in run.stderr or "Address already in use" in run.stderr)
            if retry == PORT_RETRIES or not lost:
                return run, seconds, state, stack.pop_all()
            log(f"{what}: the launcher's port {port} (or a restart's next one) was taken (EADDRINUSE); "
                f"retry {retry + 1} of {PORT_RETRIES} on a fresh port")


def _gang_workers(device, W: int, args) -> list:
    """``examples/gang.py args`` as a launcher gang of W workers; each
    process's reports."""
    def command(port, out_dir):
        return [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--nproc_per_node", str(W),
                "--max_restarts", "0", "--monitor_interval", "0.2", "--master_port", str(port),
                GANG_SCRIPT, "--device", device.type, "--warmup", str(DIST_WARMUP), "--steps", str(DIST_STEPS),
                "--report", os.path.join(out_dir, "gang")] + args

    run, _, out_dir, held = _launch(f"[dist] the gang of {W}", device, command, tempfile.TemporaryDirectory)
    with held:
        if run.returncode != 0:
            raise AssertionError(f"[dist] the gang of {W} failed (launcher rc {run.returncode}):\n"
                                 f"{run.stderr[-8000:]}")
        return [json.load(open(os.path.join(out_dir, f"gang.proc{p}.json"))) for p in range(W)]


def _check_gang_reports(what: str, got: list, W: int, k: int, device) -> None:
    for p, r in enumerate(got):
        if (r["process"], r["processes"], r["local_ranks"]) != (p, W, k):
            raise AssertionError(f"{what}: process {p} reports {r['process']}/{r['processes']} x "
                                 f"{r['local_ranks']} ranks")
        if not r["device"].startswith(device.type):
            raise AssertionError(f"{what}: process {p}'s ranks ran on {r['device']}")


def phase_dist(device, smi: str, model: str = "vgg16") -> dict:
    """The gang's run (see the module docstring, ``dist``): the launcher's
    workers, then the single-controller run of each case here; then each
    twin path of DIST_TWINS the same way.  Returns the workers' launches
    summed over the processes and paths."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    W = max(w for w in (4, 2, 1) if w <= cards and RANKS % w == 0)
    k = RANKS // W
    cases = [[algo, kw, ov, {"warmup": DIST_WARMUP + quiet}] for algo, kw, ov, _, quiet in DIST_CASES.values()]
    t0 = time.perf_counter()
    reports = _gang_workers(device, W, ["--model", model, "--ranks-per-process", str(k), "--intra-size", "1",
                                        "--cases", json.dumps(cases)])
    log(f"[dist] {W} worker process(es) x {k} ranks over {'NCCL' if device.type == 'cuda' else 'gloo'}, "
        f"{len(cases)} wires in {time.perf_counter() - t0:.1f} s; {smi}")
    total = {}
    for i, (name, (algorithm, kwargs, overlap, per_bucket, quiet)) in enumerate(DIST_CASES.items()):
        steps = DIST_WARMUP + quiet + DIST_STEPS
        got = [r[i] for r in reports]
        what = f"[dist] {name}"
        _check_gang_reports(what, got, W, k, device)
        if any(r["algorithm"] != algorithm for r in got):
            raise AssertionError(f"{what}: the processes ran {[r['algorithm'] for r in got]}")
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # the workers' cuDNN settings (examples/gang.py), for the same convolutions
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            ref = gang.run_case(BaguaProcessGroup([device] * RANKS, intra_size=1), model, algorithm, kwargs,
                                {"on": True, "off": False}.get(overlap, overlap), steps=DIST_STEPS,
                                warmup=DIST_WARMUP + quiet, processes=W)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        buckets = ref["buckets"]
        for p, r in enumerate(got):
            if r["digests"] != ref["digests"][p * k:(p + 1) * k]:
                raise AssertionError(f"{what}: process {p}'s parameters differ from the single-controller "
                                     f"run's ranks {p * k}..{(p + 1) * k - 1}")
            if r["overlap"] != ref["overlap"] or r["buckets"] != buckets:
                raise AssertionError(f"{what}: process {p} ran overlap={r['overlap']} on {r['buckets']} buckets, "
                                     f"the single-controller run {ref['overlap']} on {buckets}")
            if device.type == "cuda":
                want = {kernel: (steps - quiet) * buckets * per_bucket.get(kernel, 0) for kernel in r["launches"]}
                if r["launches"] != want or ref["launches"] != want:
                    raise AssertionError(f"{what}: process {p} launched {r['launches']}, the single controller "
                                         f"{ref['launches']}, want {want}")
                unheld = [kernel for kernel in per_bucket if not r["held"].get(kernel, {}).get("bitwise")]
                if unheld:
                    raise AssertionError(f"{what}: process {p}'s {unheld} not bitwise their plain versions: "
                                         f"{r['held']}")
        if len(set(d for r in got for d in r["digests"])) != 1 and algorithm not in ("decentralized",
                                                                                      "low_precision_decentralized"):
            raise AssertionError(f"{what}: the ranks' parameters differ across processes")
        for r in got:
            for kernel, n in r["launches"].items():
                total[kernel] = total.get(kernel, 0) + n
        wire = got[0]["wire_bytes_per_step"]
        held = {kernel: (h["shapes"][0], h["max_abs_err"]) for kernel, h in got[0]["held"].items()}
        log(f"{what}: {'VGG16 bf16' if model == 'vgg16' else model}, W={W} x {k} ranks, {buckets} buckets, "
            f"{'overlap' if ref['overlap'] else 'monolithic'}: {got[0]['ms_per_step']:.2f} ms/step "
            f"(processes {[round(r['ms_per_step'], 2) for r in got]}) against the single-controller run's "
            f"{ref['ms_per_step']:.2f} (ratio {got[0]['ms_per_step'] / ref['ms_per_step']:.3f}); a step, "
            f"process 0 sent {wire['to_other_processes']} B to other processes and {wire['to_itself']} B to "
            f"itself; launches per process {got[0]['launches']}; held against the plain versions "
            f"(first shape, max abs err) {held}; parameters bitwise the single-controller run's; {smi}")
    for name, (twin, mesh, case, warmup) in DIST_TWINS.items():
        for kernel, n in phase_dist_twin(device, smi, name, twin, mesh, case, warmup, cards).items():
            total[kernel] = total.get(kernel, 0) + n
    return total


def phase_dist_twin(device, smi: str, name: str, twin: str, mesh: dict, case: list, warmup: int,
                    cards: int) -> dict:
    """One DIST_TWINS path: the twin's case as a launcher gang of W workers
    (``mesh`` shared among them), then the same case on the
    single-controller group here (or DIST_REFERENCES' run of it).  Each
    process's parameters must be bitwise the single controller's rows, its
    launches of rows 1-2 and 6-9 exactly the single controller's, and each
    first launch of rows 6-9 within its tolerance of the plain version.  A
    fused case (``tp_fused``) also runs the unfused model on the single
    controller: the first step's losses within FUSED_LOSS_RTOL of its.
    Returns the launches summed over the processes."""
    size = math.prod(mesh.values())
    W = max(w for w in (4, 2, 1) if w <= cards and size % w == 0)
    k = size // W
    what = f"[dist] {name}"
    t0 = time.perf_counter()
    got = [r[0] for r in _gang_workers(device, W, ["--model", twin, "--mesh", json.dumps(mesh),
                                                   "--cases", json.dumps([case + [{"warmup": warmup}]])])]
    gang_s = time.perf_counter() - t0
    _check_gang_reports(what, got, W, k, device)

    def single(c):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return gang.run_case(BaguaProcessGroup([device] * size, mesh_spec=MeshSpec(mesh)), twin, *c,
                             steps=DIST_STEPS, warmup=warmup)

    reused = name in DIST_REFERENCES
    ref = DIST_REFERENCES.pop(name) if reused else single(case)
    unfused_note = ""
    if case[1].get("tp_fused"):
        unfused = single([case[0], {**case[1], "tp_fused": False}, case[2]])
        first, want = (torch.tensor(r["losses"][0], dtype=torch.float64) for r in (ref, unfused))
        if not torch.allclose(first, want, rtol=FUSED_LOSS_RTOL, atol=0.0):
            raise AssertionError(f"{what}: the fused model's first losses {first.tolist()} differ from the "
                                 f"unfused model's {want.tolist()} by more than {FUSED_LOSS_RTOL} relative")
        last, last_want = (torch.tensor(r["losses"][-1], dtype=torch.float64) for r in (ref, unfused))
        unfused_note = (f"; the first step's losses within {float(((first - want) / want).abs().max()):.2e} "
                        f"relative of the unfused model's (bound {FUSED_LOSS_RTOL}), the last step's "
                        f"{float(((last - last_want) / last_want).abs().max()):.2e} (not bounded: Adam's "
                        f"first steps follow the gradients' signs)")
        del unfused
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for p, r in enumerate(got):
        if r["digests"] != ref["digests"][p * k:(p + 1) * k]:
            raise AssertionError(f"{what}: process {p}'s parameters differ from the single-controller run's "
                                 f"ranks {p * k}..{(p + 1) * k - 1}")
        if device.type == "cuda":
            if r["launches"] != ref["launches"]:
                raise AssertionError(f"{what}: process {p} launched {r['launches']}, the single controller "
                                     f"{ref['launches']}")
            launched = [kernel for kernel in TWIN_KERNELS if r["launches"].get(kernel)]
            unheld = [kernel for kernel in launched if not r["held"].get(kernel, {}).get("within")]
            if unheld:
                raise AssertionError(f"{what}: process {p}'s first launch of {unheld} not within its tolerance "
                                     f"of the plain version: {r['held']}")
    if device.type == "cuda" and twin == "llama-7b":
        missing = [kernel for kernel in TWIN_KERNELS if not got[0]["launches"].get(kernel)]
        if missing:
            raise AssertionError(f"{what}: {missing} never launched")
    total = {}
    for r in got:
        for kernel, n in r["launches"].items():
            total[kernel] = total.get(kernel, 0) + n
    held = {kernel: (h["shapes"][0], h["max_abs_err"]) for kernel, h in got[0]["held"].items()}
    log(f"{what}: {twin} on {mesh}, W={W} x {k} ranks (gang {gang_s:.1f} s with its start), "
        f"{warmup} + {DIST_STEPS} steps: {got[0]['ms_per_step']:.2f} ms/step (processes "
        f"{[round(r['ms_per_step'], 2) for r in got]}) against the single-controller run's "
        f"{ref['ms_per_step']:.2f}{' ([mesh-engine] ' + MESH_OBS_PATH + ')' if reused else ''} "
        f"(ratio {got[0]['ms_per_step'] / ref['ms_per_step']:.3f}){unfused_note}; a step, process 0 "
        f"sent {got[0]['wire_bytes_per_step']['to_other_processes']} B to other processes and "
        f"{got[0]['wire_bytes_per_step']['to_itself']} B to itself; launches per process {got[0]['launches']} "
        f"(the single controller's {ref['launches']}); first launches held within their tolerances (first "
        f"shape, max abs err) {held}; losses {got[0]['losses']}; parameters bitwise the single-controller "
        f"run's; {smi}")
    return total


def vgg16_plan():
    """The bucket plan of VGG16 over RANKS ranks, from the model's shapes
    alone (built on the meta device); every algorithm here aligns its
    buckets to the same exchange size."""
    group = BaguaProcessGroup([torch.device("cpu")] * RANKS, intra_size=1)
    params = module_params(vgg16(device="meta"))
    return ByteGradAlgorithm().reify(group).tensors_to_buckets(params)


def main(argv) -> int:
    profile = "--profile" in argv
    smi = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    ledger = Ledger()
    phase_kernels(ledger, vgg16_plan(), device)
    phase_attention_kernels(ledger, device)
    phase_matmul_kernels(ledger, device)
    phase_rings(device)
    torch.cuda.empty_cache()
    phase_collectives(device)
    phase_reference(device)
    phase_reference_dp(device)
    phase_reference_relax(device)
    phase_llama_reference(device)
    phase_tp_reference(device)
    per_path = {}
    for name in SLICE_PATHS:
        per_path[name] = phase_slice(device, profile, name)
        torch.cuda.empty_cache()
    for name in OVERLAP_PATHS:
        per_path[f"{name} via the synthetic benchmark"] = phase_overlap(device, profile, name)
    for name in ZERO_PATHS:
        per_path[name] = phase_zero(device, profile, name)
    for name in DP_PATHS:
        per_path[name] = phase_dp(device, profile, name)
    torch.cuda.empty_cache()
    per_path["MNIST"] = phase_mnist(device)
    per_path["none"], spread_of_none = phase_relax(device, profile, "none")
    for name in RELAX_PATHS:
        if name != "none":
            per_path[name] = phase_relax(device, profile, name, spread_of_none)
    torch.cuda.empty_cache()
    per_path["Llama"] = phase_llama_slice(device, profile)
    torch.cuda.empty_cache()
    per_path["Llama tp"] = phase_llama_slice(device, profile, (1, 2, 2))
    torch.cuda.empty_cache()
    per_path["SP MLP"] = phase_sp_mlp_slice(device, profile)
    per_path["BERT SQuAD"] = phase_bert_squad(ledger, device, profile)
    for algorithm in BENCH_ALGORITHMS:
        per_path[f"BERT bench {algorithm}"] = phase_bert_bench(ledger, device, profile, algorithm)
    per_path["BERT sp"] = phase_bert_sp(ledger, device, profile)
    phase_moe_reference(device)
    per_path["MoE bench"] = phase_moe_bench(device, profile)
    per_path["MoE example"] = phase_moe_example(device)
    per_path["MoE async"] = phase_moe_async(device)
    torch.cuda.empty_cache()
    per_path["ResNet"] = phase_resnet(device, profile, "--witness" in argv)
    torch.cuda.empty_cache()
    phase_gpt_reference(device)
    for schedule in ("1f1b", "gpipe"):
        per_path[f"GPT pp {schedule}"] = phase_gpt_pp(ledger, device, profile, schedule)
    per_path["pp-mem"] = phase_pp_mem(device)
    per_path["FSDP"] = phase_fsdp(device, profile)
    phase_mesh_reference(device)
    torch.cuda.empty_cache()
    per_path["mesh Llama"] = phase_mesh_llama(ledger, device, profile)
    per_path["mesh GPT"] = phase_mesh_gpt(ledger, device, profile)
    per_path["mesh engine"] = phase_mesh_engine(ledger, device, profile)
    torch.cuda.empty_cache()
    per_path["obs"] = phase_obs(device, profile)
    torch.cuda.empty_cache()
    per_path["resil"] = phase_resil(device, profile)
    torch.cuda.empty_cache()
    per_path["verify"] = phase_verify(device)
    torch.cuda.empty_cache()
    per_path["autopilot"] = phase_autopilot(device)
    torch.cuda.empty_cache()
    per_path["fleet"], alpha = phase_fleet(device)
    torch.cuda.empty_cache()
    per_path["fleet-gang"] = phase_fleet_gang(device, smi, alpha)
    torch.cuda.empty_cache()
    per_path["sync-bn"] = phase_sync_bn(device, profile)
    torch.cuda.empty_cache()
    per_path["contrib"] = phase_contrib(device)
    torch.cuda.empty_cache()
    per_path["dist"] = phase_dist(device, smi)
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        row = ledger.rows[name]
        launches = sum(counts.get(name, 0) for counts in per_path.values())
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
        for step, sums in ledger.other_steps.items():
            if name in sums:
                kernels[-1].setdefault("other_steps", {})[step] = sums[name]
        if name == "matmul_tile":
            kernels[-1]["library"] = "torch.matmul in f32, TF32 off (the plain version is the same call)"
        elif row["library_ms"] is not None:
            kernels[-1]["library"] = ("F.scaled_dot_product_attention, a near-equivalent: it "
                                      "normalizes and returns no l or m" + (
                                          "; its one backward computes dq, dk and dv"
                                          if name != "block_attention" else ""))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
