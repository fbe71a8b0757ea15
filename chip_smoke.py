"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Usage (from the root of a checkout, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA):

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. card: name and power limit (nvidia-smi); no CUDA device is a failure.
2. build: the kernels under src/repro_torch/csrc, one nvcc per source.
3. LDA kernels against their plain PyTorch versions, on the card, at the
   main path's shapes, built from the full-size corpus's own statistics:
   alias build (V=131072, K=1024), gather build (R=4096 rows; timed also
   at R=64, the trainer's default, and 512, a call beside the per-lane
   design's and on the device's clock) and the sweep (a 262,144-token
   slice of a real chunk), each timed with CUDA
   events beside its plain version and its bounds; the sweep also on the
   whole chunk (2,097,152 positions, the launch the main path runs) with
   and without its MH steps, beside its bound on that launch, the chunk's
   figures (non-zero topics per document, tokens per word, longest run)
   and the dense design's time; and the document-list build that each
   sweep launch runs first, against its plain version on a client's n_dk.
   Every kernel is timed as a call (CUDA events) and on the device's
   clock (``device_ms``: its profiler records, the host's work left out).
   Kernels 2 and 3 also bit for bit on adversarial rows (zeros, one-hot,
   all equal, inf, inf and NaN, residuals at exactly 1.0, denormals) at
   K=1024, at K=1023 and above their staged route's width limit (the
   per-lane kernels); their times are printed beside the per-lane
   design's.
4. LDA training at full size: K=1024 over V=131072 on ~12.6M tokens, two
   clients, BSP, 4 rounds with full alias rebuilds then 3 rounds of
   incremental rebuilds.  After every round: consistency_error() == 0.0,
   no projection violations; held-out perplexity must fall.  After each
   mode, two more of its rounds run under torch.profiler (PROFILE lines:
   device time by kernel, idle share).
5. PDP kernels, from the PDP trainer's initial state on the same corpus:
   the alias build at width 2K on the full (V, 2K) dense term, the
   compacted-rows build of the R=4096 rows with the largest m_wk+s_wk mass
   (bit-equal to its plain version and to the full build's rows; timed as
   kernel 3 is, at R=64, 512 and 4096; on adversarial rows also at its
   width 2048), and the
   PDP sweep on a 131,072-token slice of client 0's first chunk, once
   with the main path's Stirling table and once with a table small enough
   that its clamps bind; and on the whole chunk as in phase 3.
6. PDP training at full size: PDPConfig(n_topics=1024, vocab_size=131072)
   at its defaults, two clients, BSP, 3 cadence rounds then 3 incremental
   rounds, with the checks of phase 4 under the PDP rules.
7. HDP kernels, from an HDPConfig(n_topics=1024, vocab_size=131072)
   trainer after one round, so that θ0 has been resampled: kernels 2, 3
   and 1 as in phase 3 with the non-uniform prior b1·θ0 (kernel 3 on the
   4,096 rows that drifted most in that round).
8. HDP training at full size: 5 cadence rounds then 5 incremental rounds,
   with the checks of phase 4 (perplexity on 256 held-out documents) and
   no violation of the client-local rules 1 ≤ m_dk ≤ n_dk; its peak
   memory beside LDA's.
9. LDA with fused_alias_build=True: kernel 6 against its plain version
   (tables and stale matrix bit-equal), timed beside kernel 2 on the same
   statistics, and on phase 3's adversarial rows at the same widths; then
   3 cadence rounds with the checks of phase 4.
10. Draws: kernels 7, 8 and 9 through ops.sample_rows_sorted,
   ops.sample_rows and ops.mh_accept on a real sorted chunk of that
   trainer with its tables, each against its plain version; kernels 7
   and 8 beside their byte bound and the bytes a card with 32-byte
   sectors moves at least (``sector_bytes``).

Serving (each right after its family's training phase, from that
phase's final trainer; ``serve_path``):

4s. serve-lda: freeze phase 4's LDA (kernel 2), fold 256 documents of
   256 tokens in with FoldInEngine(ServeConfig(max_slots=64,
   max_len=256, n_sweeps=10)) (the list build and kernel 1 once a chunk a
   step), and phase 4's 32 held-out documents; then the TCP service
   (InferenceServer, 4 client threads × 32 documents, one
   out-of-vocabulary request).  Checks: theta sums to 1, assignments in
   range, 8 documents bit-equal to reference_fold_in on the card, one the
   same alone as pooled, the snapshot unchanged, fold-in perplexity at
   most QUALITY_TOL × family.perplexity, the launch counts, every TCP
   checksum equal to the in-process engine's, the batcher alive; kernel 1
   at the serving grid's shape against its plain version; and
   save_snapshot / from_checkpoint at full width (bit-equal statistics,
   equal tables), with the file's size and the seconds.
6s, 8s. serve-pdp, serve-hdp: freeze phases 6's and 8's final
   statistics (kernel 2 at width 2048 for PDP) and fold 64 documents in
   (kernel 4, or kernel 1 with b1·θ0 and HDP's local projection), 4 of
   them checked against reference_fold_in.
9s. serve-lda-fused: freeze phase 9's fused LDA (kernel 6), fold 8
   documents in, 2 checked.
11. The launcher: ``python -m repro_torch.launch.serve --smoke`` in a
   process of its own, its server process on cuda; it must exit 0.
12. Consistency and faults, on phase 4's LDA (K=1024, V=131072, two
   clients, the sorted layout): a BSP control over 6 cadence rounds,
   timed as the others are; SSP with bound 2 over 6 cadence rounds
   (exact every round, the cache and the alias tables refreshed at rounds
   0 and 3 only, so kernel 2 launches twice in step(), clocks [6, 6]; a
   stale round profiled), then 4 rounds of it with incremental rebuilds
   (one full build, kernel 3 every round); async over 4 rounds (exact, clocks [4, 4],
   BSP's build cadence; a round profiled); BSP with the top-k filter (16,384 rows by mass
   plus 1,024 uniform ones) over 4 rounds: counts from the assignments
   minus (n_wk + Σ residuals) is 0.0 in every entry, each push sends at
   most 17,408 rows, the filter timed on a real delta and a round
   profiled; a scripted fault plan (lost push of client 0 at round 1,
   client 1 crashed over [2, 4) and rejoining at 4, client 0 straggling
   over [4, 6) with period 2) with snapshots every 2 rounds under build/:
   exact until the lost push, lossy after, the clocks and the rejoin as
   the plan resolves them; then a clean BSP run of 4 rounds against
   ``Trainer.restore`` at round 2 and 2 more rounds, n_wk and every
   client's z and n_dk bit-equal.  Held-out perplexity must fall under
   each policy; round ms print beside phase 4's BSP cadence, and the
   snapshot's bytes, save and restore seconds.  The snapshots are deleted.
13. The wire, on phase 4's LDA at full width on the first WIRE_DOCS
   (16,384) of its documents (two clients, two shard servers, in
   threads of this process unless said): (a) tcp-bsp, a tcp Trainer with
   both clients over 1 round, after it n_wk and every client's z and
   n_dk bit-equal to an in-process BSP trainer, exact, its round ms beside
   the in-process round, a pull's and a push's bytes and frames, a pull
   timed by stage (``pull_breakdown``), then ``serve.from_servers`` equal
   to ``freeze`` of the in-process statistics; sparse pushes without a
   filter over 1 round, equal to (a)'s first; (b) tcp-topk, the
   top-k filter with sparse pushes over 1 round: counts − (n_wk + Σ
   residuals) == 0.0, at most 17,408 rows a push; (c) tcp-ssp2 over 2
   rounds: exact, NOT_MODIFIED on the stale round, kernel 2 on the
   refresh only; (d) tcp-pdp, phase 6's PDP over 1 round, bit-equal to
   in process; (e) ``launch_loopback``: a shard process (two shards) and
   two worker processes on the card, 1 round, their checksums equal to
   each other's and to (a)'s first, each worker's own launches counted;
   (f) ``launch_failover`` at a reduced size (``FAILOVER``: its restarts'
   time and disk), in a thread beside (e), under build/: a dropped push
   connection, a delayed pull, the shard process killed at round 3 and
   restored from its snapshot, worker 1 killed after round 2 and
   restored, bit-equal to an undisturbed in-process run.  WIRE lines carry
   the numbers; (e)'s and (f)'s say what ran beside them (``beside``).  Every trainer of
   phases 3-13 passes ``layout="sorted"`` (the workers ``--layout
   sorted``), so their numbers stay comparable across PRs.
14. The position-scan layout, on phase 4's corpus at full width (two
   clients of 32,768 documents, BSP, kernels 8 and 9 in every MH step):
   scan-lda (``LDAConfig`` defaults, MHW, 2 cadence rounds; kernels 2, 8,
   9), scan-lda-incremental (2 rounds with phase 4's incremental
   settings; kernels 3, 8, 9), scan-lda-exact (2 rounds; kernel 2),
   scan-hdp (2 rounds, prior b1·θ0; kernels 2, 8, 9), scan-pdp (2 rounds;
   kernel 2 at width 2048, then 8 and 9 over E = 2048) and tcp-scan (one
   LDA round over two shard servers in threads, bit-equal to the same
   round in process, on phase 13's WIRE_DOCS documents).  After every
   round: exact, no violation, HDP's
   local rules; held-out perplexity falls (32 documents, 256 for HDP),
   printed beside the sorted trainer's at the same round.  Kernels 8 and
   9 must launch 2 clients × 256 positions × mh_steps times a MHW round.
   Kernels 8 and 9 on the first position's inputs of the last round of
   scan-lda (B = 32,768) and of scan-pdp (E = 2048), against their plain
   versions on the same card tensors and timed; one scan-lda round
   profiled (its window opened by ``pad_launches``, not a round);
   ``mh_chain_with_stats``'s acceptance rate after the first
   and the last scan-lda round; one scan sweep at K = 16 on the CPU and
   on the card with the same injected draws.  SCAN lines carry the
   numbers.
15. The mesh round (``core.distributed.make_round_fn``), on phase 4's
   corpus at full width, the proposal refreshed before each round (under
   SSP when the cache is): (a) NCCL at world size 1 in this process
   (``make_host_mesh(1, 1)``, one client of 65,536 documents): mesh-lda
   (sorted, 2 rounds), mesh-lda-ssp1 (3; kernel 2 at rounds 0 and 2),
   mesh-pdp (sorted, 2) and mesh-hdp-scan (the scan layout, 2; kernels 8
   and 9 exactly 256 positions × mh_steps a round), every round bit-equal
   to the same round composed in this process without torch.distributed
   (``composed_round``: ``client_round``, the push, Algorithm 1) from the
   same key, exact, no violation, HDP's local rules; LDA's held-out
   perplexity falls; the last round of each sorted path profiled
   (mesh-hdp-scan's moves what mesh-lda's does).  Each path first
   holds its kernels against their plain versions at these shapes, on
   the inputs of its first composed round: kernel 1 or 4 on a slice of
   the first sorted chunk (4,194,304 positions) whose documents lie in
   the upper half of the 65,536-row n_dk, the list build on that whole
   n_dk, kernels 8 and 9 on the first scan position (B = 65,536); (b) a
   2×2 gloo mesh of four processes with their tensors on this card (NCCL
   refuses two ranks on one device), two clients of 32,768 documents: 2 rounds under
   Algorithm 2 over the model group (the last profiled on rank 0), then 2
   under Algorithm 1 over two server shards with client 1 dead in the
   last; every rank's state (SHA-256 of each statistic, its client's
   locals, the row mass; the clocks) equal to every other's and to the
   rounds composed here from the same keys, exact on the rounds with both
   clients live, clocks [2, 2] and [2, 1]; then ``sync_compressed`` of
   each client's next delta (top-k 16,384 + 1,024 rows) equal to the sum
   of the clients' ``decompress_delta`` computed here.  MESH lines carry
   each round's ms, tokens/s, each collective's bytes and ms, peak memory
   per rank and the profiled share; a collective's ms come from the
   profiled round's trace, whose ranges ``core.collectives`` names.

16. The LM side (``repro_torch.models``, ``train``, ``optim``; no kernel
   of its own: the reference's LM path reaches no Pallas kernel).  First
   the product the reference keeps in float32 (``layers.einsum_f32``: on
   the card bf16 operands into one GEMM with a float32 result, and its
   hand-written backward) against the widened float32 product at 16a's
   MLP gate, its attention scores and that gate over eight experts
   (the grouped spec), forward and both gradients within the
   float32 accumulation bound (F32_PRODUCT_REPS), each timed.  (a)
   smollm-360m at full width and depth (32 layers, d 960, vocabulary
   49,152; 0.36 B parameters): 20 AdamW steps of 8 × 512 ``lm_batches``
   tokens with remat, the loss finite at every step and its last five
   steps' mean below its first five's; a checkpoint of the
   ``{"params", "opt"}`` tree under build/phase16 (deleted after) read
   back bit-equal, the next step from it within the spread of two twin
   steps from the live state, and two microbatches against one within
   5e-2; prefill of 512 tokens and 16 decode steps against the forward
   (``decode_check``); LM lines with tokens/s, step ms, peak GiB and
   model FLOPs/s (6·N_active·tokens) as a share of the bf16 dense peak,
   and its step ms, peak and decode gap on one line.
   (b) the other nine at full width, depth cut to 1 layer (zamba2: one
   group of 6 Mamba-2 layers and its shared block; whisper: 1 encoder and
   2 decoder layers), batch 2 × 512, random bf16 patch embeddings and
   audio frames: the forward timed, prefill and 1 decode step (3 for
   mixtral, rwkv6 and zamba2) against the forward, one full-width train
   step for those whose 16-byte-a-parameter state fits (``LM_FULL_TRAIN``),
   and one train step of each of the ten at ``reduced()`` size; each
   model freed before the next.

17. The LM side over a (data, model) mesh (``train/sharding.py``, the
   mesh step of ``train/train_step.py``; no kernel of its own).  (a)
   NCCL at world size 1 in this process: one step in each of megatron,
   zero_seq and zero_batch from 16a's final state on its batch, bit-equal
   to the one-card step (under the zero modes the one-card step under the
   mode's activation spec, which holds the block weights in bf16 as the
   reference's zero modes do; the largest difference to the plain step is
   printed).  (b) A 2×2 gloo mesh of four processes with their tensors on
   the card (``mesh_lm_rank``; started before phase 16 for the time
   limit, they run (b), 18b and 18d beside (b)'s one-card side and phase
   16, (d) beside (a) and the one-card sides of (c) and (d), and (c)
   alone; BESIDE, printed with the figures, says what ran beside each):
   smollm-360m at full width, depth cut to 8
   layers, 8 × 512 ``lm_batches`` tokens, two steps under megatron and
   one under each zero mode (MESH_LM_STEPS) from the seed's weights
   against the same steps on one card: each step's loss
   and grad_norm and the parameters after the last (Frobenius of the
   difference over that of the update, summed over the ranks' blocks,
   ``leaf_sums``) within MESH_LM_MARGIN times
   the one-card run's own spread against two and four microbatches, and
   at least MESH_LM_FLOOR; every rank's metrics equal, every rank's
   parameter, m and v blocks of their specs' shapes; the resident bytes
   a rank beside one card's; under megatron the tensor-parallel products
   (each model rank its heads, d_ff and vocabulary slice; the weights
   gathered over ``data`` and re-laid over ``model``, none gathered whole
   over ``model``), every collective of a step by name and process group
   from ``collectives.tally`` (calls and bytes a step a rank; the weights'
   gathers and the re-layouts summed apart); ``make_sync_fns``' top-k push (TOPK's rows)
   equal, digest for digest, to the sum of the clients' ``filter_tree``
   computed here.  (c) phi3.5-moe at full width (d 4096, 16 experts, d_ff
   6400), one layer, zero_batch with ``moe_groups`` 4 (one group a rank):
   ``_moe_a2a``'s block against the one-process grouped dispatch on the
   same tokens (within MESH_MOE_TOL; the one-process side runs first and
   is freed), its all_to_all spans present, then one train step; then the
   same layer under zero_seq (a group a row: each model rank dispatches
   the row ``layers.seq_groups`` gives it, the rows' tokens and routes
   moved over ``model`` alone): the block on the four ranks against the
   same one-process dispatch (MESH_MOE_TOL), then, once they have exited,
   one train step on a 1x2 gloo mesh of two processes (MOE_SEQ_STEP_MESH;
   it runs beside phase 18's parts in the smoke's process and is checked
   after them) whose ``moe seq`` exchanges on rank 0 equal
   MOE_SEQ_PREDICTED (the tally tool's) to the byte, no token-group
   gather, the peak a rank beside the tool's.  (d) The
   SSM mixers' tensor-parallel products in the same four processes before
   (c): rwkv6-3b at published widths, one layer, and zamba2-2.7b at 6
   layers (one group of Mamba-2 layers and its shared block), 2 × 512
   tokens, one megatron step each from the seed's weights (each model
   rank its heads' projections, recurrence and norm share; RWKV-6's decay
   LoRA by its columns; Mamba-2's B and C on both) against the same step
   on one card (in this process, freed; the ranks wait for its file to
   compare, not to step), by (b)'s bounds against its own
   spread with one and two microbatches, and the first gradients (AdamW's
   m after the step) leaf by leaf within MESH_LM_MARGIN times one card's
   own spread of that leaf and at least SSM_GRAD_FLOOR, for every leaf
   whose bound is below SSM_GRAD_HELD (a leaf left at zero or reversed
   exceeds it; the others are printed as not held); zamba2 again at
   float32 compute and 2 × 256 (MESH_SSM_F32: in bf16 one card's own
   Mamba-2 gradients part too far between one and two microbatches to
   hold by), where every leaf must be held; every rank's blocks
   of their specs' shapes, the collectives by name and group (none
   gathers a weight over ``model``), resident and peak GiB a rank beside
   one card's.  Then the same under zero_seq (MESH_SSM_SEQ): the two plans
   and whisper-large-v3 at published widths, one decoder and one encoder
   layer, its 1,500 frames split 750 + 750, one step each against one
   card's step under the mode's activation spec by the same bounds; each
   rank's recurrences (and whisper's encoder) on its own 256 positions
   (750 frames): no ``sequence in`` or ``frames`` gather on any rank, the
   rank-boundary state and halo exchanges on rank 0 (``seq state``,
   ``seq halo``) equal to the byte to SEQ_PREDICTED
   (``tools/torch_mesh_tally.py``), the peak GiB a rank beside the same
   step's before the change (SEQ_PEAK_BEFORE).  MESH-LM lines carry step ms and tokens/s, each collective's
   calls, bytes and ms from megatron's profiled step's spans (the zero
   modes' calls and bytes from the tally alone: the time limit), the peak
   GiB a rank and the card.

18. Serving the LM over a mesh (``model.serve_hooks``: bf16 weights over
   ``model``, rows over (pod, data), caches under ``cache_specs``; no
   kernel of its own) and one workload of the pod dry run.  (a) NCCL at
   world size 1 in this process: smollm-360m as published, 16a's final
   weights in bf16, prefill of 8 × 512 tokens and 16 decode steps, the
   logits of every call and every cache leaf bit-equal to the same calls
   on one card.  (b) A 2×2 gloo mesh of four processes on the card
   (``serve_mesh_rank``, run by phase 17's four processes after 17b,
   checked here): the same widths at 17b's depth (8 layers), the
   seed's weights in bf16, prefill of 8 × 512 and 4 decode steps under
   megatron (the serve weights re-laid once into their compute split,
   ``model.serve_params``; each model rank its heads' and slices'
   products; the K/V sequence split over ``model``, the softmax combined
   over the model group by log-sum-exp), then one prefill under zero_seq
   (each rank's own positions its K/V block): the model ranks of a row
   block equal, every rank's K/V cache of ``local_shape``'s shapes, the
   logits against one card's by 16a's decode rule (each row's correlation
   above DECODE_CORR, its largest gap within DECODE_GAP of its range);
   decode ms a step, the collectives a step a rank by name
   (``collectives.tally``; no weight gathered, and fewer bytes than
   DECODE_BYTES_BEFORE, the step's bytes when each layer's weights were
   gathered whole), the re-layout's bytes once, resident GiB a rank
   beside one card's.  (d) (d)'s two models served in the same processes
   after (b): prefill of 2 × 512 and 3 decode steps under megatron (a
   cache of 516) from ``serve_params``, each SSM state kept in its block
   (every head, its value dim split over ``model``): logits against one
   card's by 16a's decode rule, every cache leaf of ``local_shape``'s
   shape, decode ms and the collectives a step by name: no weight and no
   SSM state among them, the bytes those ``tools/torch_mesh_tally.py``
   predicts; then a zero_seq prefill of each (each rank's recurrences on
   its 256 positions, the carries sent from the last model rank to the
   cache's blocks): the model ranks of a row block bit-equal, the logits
   against one card's prefill by 16a's decode rule, every cache leaf of
   ``local_shape``'s shape, no ``sequence in`` gather, the exchanges by
   name.  (c)
   ``python -m repro_torch.launch.dryrun --arch smollm-360m --shape
   decode_32k --multi-pod`` in a subprocess started before phase 17 and
   read after (b) (it needs no card; its fake process group of 512 never
   meets a real one): status ``ok``, resident bytes a rank, collective
   bytes and the three roofline terms.  SERVE-MESH lines.

Each path (lda, pdp, hdp, lda-fused, draws, serve-lda, serve-pdp,
serve-hdp, serve-lda-fused, phase 12's bsp, ssp2, ssp2-incremental,
async, topk, faults and restore, and phase 13's tcp-bsp,
tcp-from-servers, tcp-sparse, tcp-topk, tcp-ssp2, tcp-pdp and the
loopback and failover workers, phase 14's scan-lda,
scan-lda-incremental, scan-lda-exact, scan-hdp, scan-pdp and tcp-scan, and
phase 15's mesh-lda, mesh-lda-ssp1, mesh-pdp, mesh-hdp-scan,
mesh-2x2-alg2 and mesh-2x2-alg1) is driven with the launch counters zeroed
just before it and read just after (phase 13's: around each step, and in
each worker process; phase 15b's in each rank, summed), and every kernel
of the path must have launched;
launches made only to check a path are left out.
Phases 13-15 print each path's seconds on the host's clock (PATH lines,
a PATHS line at each phase's end: set-up, rounds and checks).
The last lines are the kernels JSON, the card, and the result JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor-core fp32
SWEEP_SLICE = 262_144
PDP_SWEEP_SLICE = 131_072
GATHER_ROWS = 4096
SWEEP_MISMATCH_TOL = 1e-3      # share of chains that may differ (see below)
DIST_ABS, DIST_REL = 2e-6, 1e-4  # encoded distribution vs p/Σp
# Operations of the PDP sweep, each log and exp counted as one (which
# understates them: CUDA's precise logf and expf are tens of
# instructions).  The log factors of a (word, topic) cell depend on the
# token only at the token's own topic, and those of a cell with m_wk = 0
# on its topic alone, so the work the function needs is: per (word, topic)
# cell with m_wk > 0 of the words touched, and once per topic for the empty
# cells, the CRP repair (3), the occupancy term (2), four logs and their
# argument adds (8), four clamps (8), two Stirling differences (2), the
# sums of the two factors (9) and two exps (2);
PDP_WORD_OPS = 34
# per topic, once: log(b + m_k), log(b + a·s_k), log(γ̄ + s_k) (7);
PDP_TOPIC_OPS = 7
# per real token at its document's non-zero topics and its own (a zero
# count gives an exact zero weight): two document-factor products, two cdf
# adds and one compare per outcome and MH step (4 + 2·mh_steps);
# per real token: the own topic's factors again with the own counts
# removed (4 + 34 + 7), log p and log q at the initial state (9), and at
# each MH step those of the candidate and the accept (14).
PDP_TOKEN_OPS, PDP_STEP_OPS = 54, 14
# Kernel 1's function: per (word, topic) cell it needs (``lm_word_cells``)
# the LM entry (two adds, a division); per token at its document's non-zero
# topics and its own, the weight and its cdf add, and a compare per MH
# step; per token the own topic's entry (5), log p and log q at the
# initial state (12), and at each MH step the dense draw's compare, the
# mixture pick (3), log p and log q of the candidate (12) and the accept
# (5).
LM_ROW_OPS, LM_TOKEN_OPS, LM_STEP_OPS = 3, 17, 21
# Full-chunk times of kernels 1 and 4 in their dense design (one warp a
# token, every topic), from this script's run before the sparse redesign
# on another call and card (NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel
# table), printed on the SWEEP lines beside this run's for reference, not
# compared in one call and kept out of the kernels JSON.
DENSE_FULL_CHUNK_MS = {"mhw_sweep_fused": 8.53, "pdp_sweep_fused": 34.53}
# Times of kernels 2 and 6 in their per-lane design (one lane a row, the
# pairing on device memory), from this script's run before the staged
# redesign on another call and card (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md's kernel table), printed on the ALIAS lines beside this run's
# for reference, not compared in one call and kept out of the kernels JSON.
PER_LANE_MS = {"alias_build": 12.45, "alias_build (hdp)": 12.26,
               "alias_build width 2K": 26.28, "alias_build_fused": 12.70}
# Kernels 3 and 5 in their per-lane design at the R rows that the KERNEL
# lines time them at: a call of the C entry point as
# tools/torch_alias_split.py times it (time_ms), the mean of two runs of
# the tree before their staged redesign in one call of that tool on
# another card (NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel table),
# printed on the ALIAS lines beside this run's for reference, not
# compared in one call and kept out of the kernels JSON.
PER_LANE_MS.update({
    "alias_build_gather_fused R=64": 2.082,
    "alias_build_gather_fused R=512": 2.297,
    "alias_build_gather_fused R=4096": 3.063,
    "alias_build_gather_fused (hdp) R=64": 2.077,
    "alias_build_gather_fused (hdp) R=512": 2.262,
    "alias_build_gather_fused (hdp) R=4096": 3.343,
    "alias_build_rows R=64": 2.081, "alias_build_rows R=512": 3.325,
    "alias_build_rows R=4096": 6.397})
INCREMENTAL_ROWS = (64, 512, 4096)   # the trainer's default, and GATHER_ROWS
ADVERSARIAL_ROWS = 301          # not a multiple of any plan's rows a block
ADVERSARIAL_ROWS_WIDE = 37
PROFILE_TAIL = ("alias_build", "sort", "memcpy")   # shown beyond the top 15
PROFILE_ATTEMPTS = 3            # profiled windows before a lost record fails
PROFILE_PAD, PROFILE_PAD_S = 200, 0.1   # pad_launches: a window's opening
# The serving paths' engine: 64 documents a step, slots of 256 tokens,
# 10 sweeps a document (the training-time evaluators' fold-in length).
SERVE = {"max_slots": 64, "max_len": 256, "n_sweeps": 10}
QUALITY_TOL = 1.25   # fold-in over family perplexity (bench_serve.py)
LAUNCHER_TIMEOUT_S = 300
# Phase 12's top-k filter: 1/8 of the vocabulary's rows by L1 mass a push,
# plus 1,024 uniform rows against starvation (paper §5.3).
TOPK = {"k_rows": 16384, "random_rows": 1024}
SUMMARIES: dict[str, dict] = {}   # TRAIN lines by path and mode
# Phase 13: the shard servers' barrier and liveness timeouts (a full-width
# frame is hundreds of MiB), the launchers' limit, the failover run's
# reduced size (its restarts' time and disk), and the WIRE lines by path.
WIRE_TIMEOUT_S = 600.0
# Phase 13 and tcp-scan run on the first WIRE_DOCS of phase 4's 65,536
# documents (the corpus draws document by document, so they are the
# corpus of WIRE_DOCS documents the loopback's workers draw): a round's
# frames are (V, K) whatever the documents, and the workers' own corpus
# build took ~21 s of host time at 65,536 on an H100 machine.
WIRE_DOCS = 16_384
LOOPBACK_TIMEOUT_S = 300.0
FAILOVER = {"n_topics": 64, "vocab_size": 8192, "n_docs": 2048,
            "doc_len": 64, "corpus_seed": 3}
WIRE: dict[str, dict] = {}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase(name: str, t0: float) -> None:
    print(f"PHASE {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


# Phases 13-15 by path: {phase: {path: seconds on the host's clock}}.
PATHS: dict = {}


def path_seconds(ph: str, name: str, t0: float) -> float:
    """The seconds since ``t0`` of phase ``ph``'s path ``name`` (its
    set-up, rounds and checks), printed and kept for the phase's PATHS
    line."""
    secs = time.perf_counter() - t0
    PATHS.setdefault(ph, {})[name] = round(secs, 1)
    print(f"PATH {ph} {name} {secs:.1f} s", flush=True)
    return secs


def paths_line(ph: str) -> None:
    print(f"PATHS {ph} {json.dumps(PATHS.get(ph, {}))}", flush=True)


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, symbol: str = "alias_build") -> float:
    """Median milliseconds, on the device's clock, of the kernels whose
    symbol contains ``symbol`` that ``reps`` calls of ``fn`` launch, one a
    call: their CUDA records in a torch.profiler trace.  The host's work of
    a call (allocation, checks and the syncs they make, the launch), which
    ``time_ms`` counts, is left out.  Late in a run a window may lose its
    first records (see ``profile_round``: ten kernel-2 calls of HDP's phase
    kept their last two), so it opens with ``PROFILE_PAD`` small launches
    over at least ``PROFILE_PAD_S`` seconds and ``reps`` more calls, and
    only the last ``reps`` records are read; a window with fewer is taken
    again, up to ``PROFILE_ATTEMPTS`` times."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad_launches()
            for _ in range(2 * reps):
                fn()
            torch.cuda.synchronize()
        records = sorted((e.time_range for e in prof.events()
                          if e.device_type == cuda and symbol in e.name),
                         key=lambda r: r.start)
        if len(records) >= reps:
            return statistics.median(r.elapsed_us() / 1e3
                                     for r in records[-reps:])
    raise AssertionError(f"device_ms: {len(records)} of {2 * reps} {symbol} "
                         "launches traced")


def enqueue_us(run, calls: int = 50) -> float:
    """Host microseconds a call of ``run`` takes to enqueue its launch, the
    device held busy meanwhile so that the queue never waits."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t = time.perf_counter()
    for _ in range(calls):
        run()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encoded(prob: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """The distribution each alias row draws from."""
    k = prob.shape[1]
    q = prob.double().clone()
    q.scatter_add_(1, alias.long(), 1.0 - prob.double())
    return q / k


def check_tables(name, p, prob, alias, mass, prob_ref, alias_ref, mass_ref):
    """The kernel's tables equal the plain version's bit for bit on every
    row (the kernel sums each row's mass left to right, the plain
    version's order), and they encode the row's exact distribution p/Σp
    (summed in float64) to DIST_ABS + DIST_REL·(p/Σp) + δ·(1 + p/Σp).
    δ = |mass/Σp − 1| is the relative error of the plain version's float32
    row mass (up to (E−1)·2⁻²⁴ over E terms): the build scales every entry
    by that mass, and since the encoded distribution sums to 1, the
    deficit ends in the slots left at prob = 1.  Rows of a few large and
    many nearly equal tiny entries (the PDP term's r = 1 half) round the
    same way at every add, so there δ is systematic.  Returns match
    statistics."""
    same = mass == mass_ref
    if not (bool(same.all()) and torch.equal(alias, alias_ref)
            and torch.equal(prob, prob_ref)):
        raise AssertionError(
            f"{name}: kernel and plain tables differ: "
            f"{int((~same).sum())} row masses, "
            f"{int((alias != alias_ref).sum())} alias entries, "
            f"{int((prob != prob_ref).sum())} prob entries")
    exact = p.double().sum(1, keepdim=True)
    target = torch.where(exact > 0, p.double() / exact.clamp_min(1e-300),
                         torch.full_like(exact, 1.0 / p.shape[1]))
    delta = torch.where(exact > 0, (mass_ref.double()[:, None] / exact
                                    - 1).abs(), torch.zeros_like(exact))
    err = (encoded(prob_ref, alias_ref) - target).abs()
    lim = DIST_ABS + DIST_REL * target + delta * (1 + target)
    use = err / lim
    if not bool((use <= 1).all()):
        r, c = divmod(int(use.argmax()), p.shape[1])
        raise AssertionError(
            f"{name}: tables are off the row's distribution by up to "
            f"{float(err.max())}; worst entry ({r}, {c}): err "
            f"{float(err[r, c])}, bound {float(lim[r, c])}, target "
            f"{float(target[r, c])}, row mass error {float(delta[r, 0])}")
    return {"bit_equal": True, "max_abs_err": 0.0,
            "dist_max_err": float(err.max()),
            "dist_bound_use": float(use.max()),
            "mass_rel_err_max": float(delta.max())}


def adversarial_rows(k: int, n_rows: int, seed: int) -> np.ndarray:
    """(n_rows, k) float32 rows for the corner cases of the alias builds,
    then seeded random rows: all zeros (the uniform fallback); one-hot at
    the first, the last and a middle entry; all equal, at 1 and at 0.25
    (no small entry); one inf; one inf and one NaN; halves, ones and
    one-and-a-halves, whose pairing puts residuals at exactly 1.0 (the
    edge of the small test) wherever scaled stays exact; denormals, with
    zeros and alone; then sparse gamma rows, some with a spike."""
    rng = np.random.default_rng(seed)
    rows = []
    for kind in ("zeros", "one_hot", "equal", "inf", "residual",
                 "denormal"):
        for variant in range(3):
            row = np.zeros(k, np.float32)
            if kind == "one_hot":
                row[(0, k - 1, k // 2)[variant]] = 1.0
            elif kind == "equal":
                row[:] = (1.0, 0.25, 3.0)[variant]
            elif kind == "inf":
                row[:] = rng.gamma(0.5, size=k)
                row[k // 3] = np.inf
                if variant:
                    row[(2 * k) // 3 if variant == 1 else 0] = np.nan
            elif kind == "residual":
                m = max(1, k // (4 + variant))
                row[:] = 1.0
                row[:m] = 0.5
                row[k - m:] = 1.5
                if 2 * m > k:
                    row[:] = 1.0
            elif kind == "denormal":
                tiny = np.float32(1e-40) * np.arange(1, k + 1, dtype=np.float32)
                row[:] = np.where(rng.random(k) < 0.5, tiny, 0.0)
                if variant == 1:
                    row[:] = np.float32(1.4e-45)
                elif variant == 2:
                    row[0] = 1.0
            elif variant:
                break
            rows.append(row)
    while len(rows) < n_rows:
        row = rng.gamma(0.3, size=k) * (rng.random(k) < 0.6)
        if rng.random() < 0.3:
            row[rng.integers(k)] = 100.0 * row.sum() + 1.0
        rows.append(row.astype(np.float32))
    return np.stack(rows[:n_rows])


def per_lane_line(name: str, ms: float, dev_ms: float | None = None) -> None:
    on_device = "" if dev_ms is None else f" ({dev_ms:.3f} on the device)"
    print(f"ALIAS {name}: {ms:.3f} ms a call{on_device}; per-lane design "
          f"{PER_LANE_MS[name]} ms a call (an earlier run, on another call "
          "and card)", flush=True)


def adversarial_check(name: str, dev) -> dict:
    """Kernel 2 (``alias_build``), 3 (``alias_build_gather_fused``), 5
    (``alias_build_rows``) or 6 (``alias_build_fused``) against its plain
    version, bit for bit, on ``adversarial_rows`` at full width (K=1024;
    kernel 5 also at its main path's 2048), at K=1023 (not a multiple of
    32 or 4) and at the width above the staged route's limit (per lane),
    R=301 rows (37 above the limit).  Kernels 3 and 6 take the rows as
    n_wk with β = 0, n_k = 1 and a prior (kernel 3) or α (kernel 6) of 1,
    where their formulas pass them through unchanged; kernel 3 gathers all
    of them in a seeded order.  Returns the widths checked."""
    from repro_torch.core import alias as alias_mod
    from repro_torch.kernels import alias_build as kab
    from repro_torch.kernels import ref

    kernel = {"alias_build": 2, "alias_build_gather_fused": 3,
              "alias_build_rows": 5, "alias_build_fused": 6}[name]
    above = kab.staged_max_width(kernel) + 1
    widths = (1024, 1023) + ((2048,) if kernel == 5 else ()) + (above,)
    n_rows = []
    for k in widths:
        n = ADVERSARIAL_ROWS if k <= 4096 else ADVERSARIAL_ROWS_WIDE
        n_rows.append(n)
        rows = torch.as_tensor(adversarial_rows(k, n, seed=k), device=dev)
        ones = torch.ones(k, device=dev)
        if kernel == 6:
            got = kab.alias_build_fused(rows, ones, alpha=1.0, beta=0.0,
                                        beta_bar=0.0)
            want = ref.alias_build_fused_ref(rows, ones, alpha=1.0, beta=0.0,
                                             vocab_size=n)
        elif kernel == 3:
            gen = torch.Generator(device=dev)
            gen.manual_seed(k)
            idx = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
            got = kab.alias_build_gather_fused(rows, ones, ones, idx,
                                               beta=0.0, beta_bar=0.0)
            want = ref.alias_build_gather_fused_ref(rows, ones, ones, idx,
                                                    beta=0.0, beta_bar=0.0)
        else:
            build = kab.alias_build if kernel == 2 else kab.alias_build_rows
            got = build(rows)
            want = alias_mod.build(rows)
        for part, g, w in zip(("prob", "alias", "mass", "dense"), got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(
                    f"{name} on adversarial rows at K={k}: "
                    f"{int((g.view(torch.int32) != w.view(torch.int32)).sum())}"
                    f" {part} entries differ from plain")
    out = {"widths": list(widths), "rows": n_rows,
           "staged_max_width": above - 1, "bit_equal": True}
    print(f"ADVERSARIAL {name} {json.dumps(out)}", flush=True)
    return out


def pad_launches() -> None:
    """``PROFILE_PAD`` small launches over at least ``PROFILE_PAD_S``
    seconds: the opening of a profiled window where no other call of the
    measured function can run."""
    pad = torch.zeros(1, device="cuda")
    t, n = time.perf_counter(), 0
    while n < PROFILE_PAD or time.perf_counter() - t < PROFILE_PAD_S:
        pad.add_(1.0)
        n += 1


def profile_window(fn, opening=None):
    """``opening()`` (by default ``pad_launches``) then one call of ``fn`` inside the range "measured
    call", under torch.profiler.  A profiled window may lose device
    records at its start (see ``profile_round``), which ``opening`` fills.
    The call is read from the start of its range's device-side copy on
    (the device's own clock, no host/device clock comparison).  Returns
    (fn's result, its wall ms closed by a sync, its device-side records by
    name as [ms, count], whether the trace held the range's device-side
    copy (the records are empty if not), the trace's events)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (opening or pad_launches)()
        torch.cuda.synchronize()
        with record_function("measured call"):
            t = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    span = [e.time_range for e in events
            if e.name == "measured call" and e.device_type == cuda]
    by_name: dict[str, list] = {}
    for e in events:
        # Device-side entries only (kernels, copies); the host ops that
        # launched them report the same time again.
        if (e.device_type != cuda or e.name == "measured call"
                or not span or e.time_range.start < span[0].start):
            continue
        row = by_name.setdefault(e.name[:90], [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3
        row[1] += 1
    return result, wall_ms, by_name, bool(span), events


def profile_round(trainer, label: str, mode: str,
                  opening_round: bool = True) -> None:
    """Two more rounds of the trainer's ``mode`` (cadence or incremental)
    under torch.profiler (``profile_window``), the first the window's
    opening, the second measured: device time by kernel and the device's
    busy share of the round's wall time.  Without ``opening_round`` the
    window opens with ``pad_launches`` (a scan round's trace is reduced to
    its events in ~35 s of host time, which its alias build, at the
    round's end, does not need).
    A profiled window may lose device records: in the fused-LDA round the
    counters showed kernel 6's launch while the trace started ~6 ms in, and
    a warm-up kernel with a 50 ms pause first did not help; one HDP round
    of a later run traced none of its one alias build.  So the first round
    fills the window's start, and a trace that does not hold every alias
    build the measured round launched is taken again, up to
    ``PROFILE_ATTEMPTS`` windows; the line says how many it took.
    These launches are not main-path launches, so the counters are
    restored afterwards."""
    from repro_torch.kernels import _build
    cuda = torch.autograd.DeviceType.CUDA
    saved = dict(_build.LAUNCHES)
    before: dict = {}

    def measured():
        before.clear()
        before.update(_build.LAUNCHES)
        trainer.step()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        _, wall_ms, by_name, ranged, events = profile_window(
            measured, trainer.step if opening_round else None)
        builds = sum(n - before.get(name, 0)
                     for name, n in _build.LAUNCHES.items()
                     if name.startswith("alias_build"))
        traced = sum(n for name, (_, n) in by_name.items()
                     if "alias_build" in name)
        if traced == builds:
            break
        print(f"PROFILE {label} {mode} window {attempt}: the measured round "
              f"launched {builds} alias builds, the trace holds {traced}"
              + ("" if ranged else " (no device-side range)"), flush=True)
    restore_counts(saved)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"PROFILE {label} {mode} round: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; alias builds traced "
          f"{traced} of {builds} launched; profiled windows {attempt}")
    # The 15 costliest entries, then the alias build, sorts and copies
    # below them by name: an incremental round's tail.
    tail = [r for r in rows[15:] if any(
        key in r[2].lower() for key in PROFILE_TAIL)]
    for ms, n, k in rows[:15] + tail:
        print(f"  {ms:9.2f} ms {n:6d} x {k}")
    # Host syncs: each tensor-to-host read waits for the device there.
    host = [e.time_range for e in events
            if e.name == "measured call" and e.device_type != cuda]
    for op in ("aten::_local_scalar_dense", "aten::nonzero"):
        calls = [e.time_range.elapsed_us() / 1e3 for e in events
                 if e.name == op and e.device_type != cuda and host
                 and host[0].start <= e.time_range.start <= host[0].end]
        print(f"  host syncs {op}: {len(calls)} calls, {sum(calls):.2f} ms "
              "on the host's clock (waits included)")
    if traced != builds:
        raise AssertionError(f"{label} {mode}: in {PROFILE_ATTEMPTS} "
                             "profiled windows the measured round launched "
                             f"{builds} alias builds, the trace held "
                             f"{traced}")


def held_out_docs(phi: np.ndarray, n_docs: int, doc_len: int, seed: int):
    """Documents drawn as the corpus draws them, from its own topics."""
    rng = np.random.default_rng(seed)
    k, v = phi.shape
    tokens = np.zeros((n_docs, doc_len), np.int32)
    mask = np.zeros((n_docs, doc_len), bool)
    for d in range(n_docs):
        length = int(rng.integers(doc_len // 2, doc_len + 1))
        zs = rng.choice(k, size=length, p=rng.dirichlet(np.full(k, 0.2)))
        for t in np.unique(zs):
            idx = np.nonzero(zs == t)[0]
            tokens[d, idx] = rng.choice(v, size=idx.size, p=phi[t])
        mask[d, :length] = True
    return tokens, mask


def sweep_bytes(rows, docs, slot, v, k, e_out, steps, word_cells,
                topic_stats):
    """What a sweep must move for one launch: the ``word_cells`` 4-byte
    cells of the word statistics that its function needs (see
    ``lm_word_cells`` and ``pdp_word_cells``) and the n_dk row of each
    document; prob and alias at the distinct (word, slot) entries its draws
    name; stale at the initial state and at each step's candidate (counted
    per read, at most (1 + mh_steps)·4 B a token); the ``topic_stats``
    per-topic aggregates and the prior; mass once per word; rows, the
    initial state and the result for every position; docs and the five
    uniform streams for real tokens only (padding exits before reading
    them).  Returns (total, parts)."""
    real = rows < v
    n_real = int(real.sum())
    r_real = rows[real].long()
    u_rows = int(torch.unique(r_real).numel())
    u_docs = int(torch.unique(docs[real]).numel())
    u_slots = int(torch.unique(r_real * e_out + slot[:, real].long()).numel())
    b = rows.shape[0]
    parts = {"word_cells": word_cells * 4,
             "n_dk_rows": u_docs * k * 4,
             "prob_alias_points": u_slots * 8,
             "stale_points": (1 + steps) * n_real * 4,
             "aggregates_prior_mass": (topic_stats * k + e_out) * 4
             + u_rows * 4,
             "streams": b * 12 + n_real * 4 + steps * n_real * 20}
    return sum(parts.values()), parts


def lm_word_cells(rows, docs, z0, n_dk, v: int) -> int:
    """The n_wk cells kernel 1's function needs: per distinct word, each
    topic that is non-zero in one of its tokens' documents or is one of its
    tokens' own.  Elsewhere the weight n_dk·lm is an exact zero (lm is
    finite), so no other cell is read for the cdf; the MH candidates'
    cells outside these are not counted."""
    real = rows < v
    words, w_of = torch.unique(rows[real].long(), return_inverse=True)
    n_docs = n_dk.shape[0]
    pairs = torch.unique(w_of * n_docs + docs[real].long())
    incidence = torch.sparse_coo_tensor(
        torch.stack([pairs // n_docs, pairs % n_docs]),
        torch.ones(pairs.numel(), device=rows.device),
        (words.numel(), n_docs), check_invariants=True)
    cover = torch.sparse.mm(incidence, (n_dk != 0).float()) > 0
    cover[w_of, z0[real].long()] = True
    return int(cover.sum())


def pdp_word_cells(rows, m_wk, v: int) -> tuple[int, int]:
    """The m_wk and s_wk cells kernel 4's function needs: the whole m_wk
    row of each word it touches (a factor that is not finite makes a NaN
    weight even where n_dk is 0, so every cell is looked at), and s_wk at
    its non-zero m_wk cells only (the CRP repair gives s = 0 where m = 0).
    Returns (m_wk cells, s_wk cells)."""
    words = torch.unique(rows[rows < v].long())
    nnz = sum(int((m_wk[words[i:i + 8192]] != 0).sum())
              for i in range(0, words.numel(), 8192))
    return words.numel() * m_wk.shape[1], nnz


def visited_topics(rows, docs, n_dk, v: int) -> int:
    """Σ over the real tokens of k_d + 1: the document's non-zero topics
    and the token's own, the topics whose weights the function needs."""
    real = rows < v
    k_d = (n_dk != 0).sum(1)
    return int((k_d[docs[real].long()] + 1).sum())


def lm_sweep_ops(rows, docs, n_dk, v: int, cells: int, steps: int) -> dict:
    """Operations of kernel 1's function on one launch, with ``cells`` from
    ``lm_word_cells`` (see LM_ROW_OPS)."""
    n_real = int((rows < v).sum())
    return {"word_cells": cells * LM_ROW_OPS,
            "token_weights": visited_topics(rows, docs, n_dk, v)
            * (2 + steps),
            "token_points": n_real * (LM_TOKEN_OPS + LM_STEP_OPS * steps)}


def pdp_sweep_ops(rows, docs, n_dk, v: int, k: int, nnz: int,
                  steps: int) -> dict:
    """Operations of kernel 4's function on one launch, with ``nnz`` the
    non-zero m_wk cells of the words it touches (see PDP_WORD_OPS)."""
    n_real = int((rows < v).sum())
    return {"word_factors": nnz * PDP_WORD_OPS,
            "empty_cells": k * PDP_WORD_OPS,
            "topic_terms": k * PDP_TOPIC_OPS,
            "token_outcomes": visited_topics(rows, docs, n_dk, v) * 2
            * (2 + steps),
            "token_points": n_real * (PDP_TOKEN_OPS + PDP_STEP_OPS * steps)}


def chunk_figures(rows, docs, n_dk, v: int, tile: int = 128) -> dict:
    """What sizes the sparse sweeps' work on one chunk: non-zero topics per
    document (k_d) over the chunk's documents, real tokens per distinct
    word, the longest run of one word, and (tile of 128 positions, word)
    segments, each of which builds its word's factors once."""
    real = rows < v
    _, runs = torch.unique_consecutive(rows[real], return_counts=True)
    pos = torch.arange(rows.shape[0], device=rows.device)
    starts = real & ((pos % tile == 0)
                     | torch.cat([real[:1], rows[1:] != rows[:-1]]))
    k_d = (n_dk[torch.unique(docs[real].long())] != 0).sum(1).float()
    n_real = int(real.sum())
    return {"positions": int(rows.shape[0]), "real_tokens": n_real,
            "distinct_words": int(runs.numel()),
            "tokens_per_word": n_real / max(1, int(runs.numel())),
            "longest_run": int(runs.max()), "tile_word_segments":
            int(starts.sum()), "k_d_mean": float(k_d.mean()),
            "k_d_max": int(k_d.max())}


def split_ms(run, gen, dev, e_out: int, steps: int, b: int) -> dict:
    """Milliseconds of a sweep launch ``run(uniforms)`` on ``b`` positions
    with S = ``steps`` uniform rows and with S = 0, where the MH step loop
    does not run: the difference is the steps' share."""
    from repro_torch.kernels import ops

    ms_s = {}
    for s in (steps, 0):
        uni = ops._step_uniforms(gen, e_out, s, b, dev)
        ms_s[s] = time_ms(lambda: run(uni), 5)
    return ms_s


SWEEP_SYMBOLS = {"mhw_sweep_fused": "mhw_sweep_kernel",
                 "pdp_sweep_fused": "pdp_sweep_kernel"}


def full_chunk(name, run, gen, dev, e_out, steps, b, bytes_full, ops_full,
               figures, label) -> dict:
    """A sweep kernel on a full chunk of ``b`` positions with and without
    its MH steps (``split_ms``), beside its bound on that launch, and with
    them on the device's clock (the sweep kernel alone: not the list build
    before it, nor kernel 4's per-topic table); the dense design's time is
    printed, not returned."""
    from repro_torch.kernels import ops

    ms_s = split_ms(run, gen, dev, e_out, steps, b)
    uni = ops._step_uniforms(torch.Generator(device=dev).manual_seed(0),
                             e_out, steps, b, dev)
    dev_ms = device_ms(lambda: run(uni), 5, SWEEP_SYMBOLS[name])
    del uni
    nbytes, nops = sum(bytes_full.values()), sum(ops_full.values())
    b_full, by_full = bound(nbytes, nops)
    print(f"SWEEP {name}{label} full chunk ({b} positions): "
          f"{ms_s[steps]:.3f} ms with S={steps} ({dev_ms:.3f} on the "
          f"device), {ms_s[0]:.3f} ms with S=0; "
          f"bound {b_full:.4f} ms ({by_full}); dense design "
          f"{DENSE_FULL_CHUNK_MS[name]} ms (an earlier run, on another call "
          f"and card); chunk {json.dumps(figures)}", flush=True)
    return {"full_chunk_tokens": b, "full_chunk_ms": ms_s[steps],
            "full_chunk_device_ms": dev_ms, "full_chunk_ms_S0": ms_s[0],
            "full_chunk_bound_ms": b_full, "full_chunk_bound_by": by_full,
            "full_chunk_bound_bytes_ms": bound(nbytes, 0)[0],
            "full_chunk_bound_ops_ms": bound(0, nops)[0],
            "full_chunk_bytes": nbytes, "full_chunk_bytes_parts": bytes_full,
            "full_chunk_ops": nops, "full_chunk_ops_parts": ops_full,
            "chunk": figures}


def doc_list_check(n_dk) -> torch.Tensor:
    """The document-list build that kernels 1 and 4 launch first, against
    its plain version on a (D, K) n_dk: the bitmaps and prefix counts
    equal, and the counts equal up to each document's k_d (the kernel
    leaves the rest unwritten).  Returns k_d."""
    from repro_torch.kernels import doc_topics, ref

    words, counts = doc_topics.doc_topic_lists(n_dk)
    want_w, want_c = ref.doc_topic_lists_ref(n_dk)
    k_d = want_w[:, -1, 1].long()
    valid = torch.arange(n_dk.shape[1], device=n_dk.device)[None, :] < \
        k_d[:, None]
    if not (torch.equal(words, want_w)
            and torch.equal(counts[valid], want_c[valid])):
        raise AssertionError(
            f"doc_topic_lists: {int((words != want_w).sum())} words and "
            f"{int((counts[valid] != want_c[valid]).sum())} counts differ "
            "from plain")
    return k_d


def doc_list_kernel(n_dk) -> dict:
    """The document-list build on a client's n_dk (``doc_list_check``),
    timed beside its plain version and its bound."""
    from repro_torch.kernels import doc_topics, ref

    k_d = doc_list_check(n_dk)
    d, k = n_dk.shape
    ms = time_ms(lambda: doc_topics.doc_topic_lists(n_dk), 20)
    dev_ms = device_ms(lambda: doc_topics.doc_topic_lists(n_dk), 20,
                       "doc_topics_kernel")
    plain = time_ms(lambda: ref.doc_topic_lists_ref(n_dk), 3)
    parts = {"n_dk": d * k * 4, "words": d * ref.doc_words(k) * 8,
             "counts": int(k_d.sum()) * 2}
    nbytes = sum(parts.values())
    b, by = bound(nbytes, 0)
    entry = {
        "name": "doc_topic_lists", "route": "cuda",
        "source": "src/repro_torch/csrc/doc_topics.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel of its own: the lists of each "
                         "document's non-zero topics that kernels 1 and 4 "
                         "(mhw_fused.py:153, :322) read in place of n_dk rows",
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain, "bound_ms": b,
        "bound_by": by, "library_ms": None, "bytes": nbytes,
        "bytes_parts": parts, "docs": d, "k_d_mean": float(k_d.float().mean()),
        "k_d_max": int(k_d.max()), "max_abs_err": 0}
    print(f"KERNEL doc_topic_lists {json.dumps(entry)}", flush=True)
    return entry


def lm_kernels(dev, tr, cfg, ccfg, dp, prior, rows_k3, label="") -> list:
    """Kernels 2, 3 and 1 against their plain versions on an LM family's
    dense term ``dp`` with its per-topic ``prior``: LDA's α·1 (phase 3) or
    HDP's b1·θ0 (phase 7, ``label`` " (hdp)"); kernel 3 on ``rows_k3``."""
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import mhw
    from repro_torch.data import segment
    from repro_torch.kernels import alias_build as kab
    from repro_torch.kernels import mhw_fused as kmf
    from repro_torch.kernels import ops, ref

    v, k = cfg.vocab_size, cfg.n_topics
    beta_bar = cfg.beta * v
    shared = tr.shared
    report = []

    # Kernel 2: full build.
    prob, alias, mass = kab.alias_build(dp)
    prob_r, alias_r, mass_r = alias_mod.build(dp)
    stats2 = check_tables("alias_build" + label, dp, prob, alias, mass,
                          prob_r, alias_r, mass_r)
    del prob_r, alias_r, mass_r
    ms2 = time_ms(lambda: kab.alias_build(dp), 5)
    dev2 = device_ms(lambda: kab.alias_build(dp), 5)
    plain2 = time_ms(lambda: alias_mod.build(dp), 2)
    # Reads p; writes prob and alias (V, K) and mass (V,).
    bytes2 = v * k * 4 + v * k * 8 + v * 4
    b2, by2 = bound(bytes2, 0)
    report.append({
        "name": "alias_build", "route": "cuda",
        "source": "src/repro_torch/csrc/alias_build.cu",
        "replaces": "src/repro/kernels/alias_build.py:186",
        "ms": ms2, "device_ms": dev2, "plain_ms": plain2, "bound_ms": b2,
        "bound_by": by2, "library_ms": None, "bytes": bytes2, **stats2})
    print(f"KERNEL alias_build{label} {json.dumps(report[-1])}", flush=True)
    per_lane_line("alias_build" + label, ms2)

    # Kernel 3: gather build of R rows; its rows must equal the full build's.
    g = kab.alias_build_gather_fused(shared.n_wk, shared.n_k, prior, rows_k3,
                                     beta=cfg.beta, beta_bar=beta_bar)
    g_r = ref.alias_build_gather_fused_ref(shared.n_wk, shared.n_k, prior,
                                           rows_k3, beta=cfg.beta,
                                           beta_bar=beta_bar)
    if not torch.equal(g[3], g_r[3]):
        raise AssertionError(f"gather build{label}: dense rows differ from "
                             "plain")
    ridx = rows_k3.long()
    if not (torch.equal(g[3], dp[ridx]) and torch.equal(g[0], prob[ridx])
            and torch.equal(g[1], alias[ridx])
            and torch.equal(g[2], mass[ridx])):
        raise AssertionError(f"gather build{label} differs from the full "
                             "build's rows")
    stats3 = check_tables("alias_build_gather_fused" + label, g_r[3], g[0],
                          g[1], g[2], g_r[0], g_r[1], g_r[2])

    def run3(fn, sel):
        return lambda: fn(shared.n_wk, shared.n_k, prior, sel,
                          beta=cfg.beta, beta_bar=beta_bar)

    def bytes3(r):
        # Reads the R gathered n_wk rows, n_k, prior and rows; writes
        # prob, alias and dense (R, K) and mass (R,).
        return r * k * 4 + 2 * k * 4 + r * 4 + r * k * 12 + r * 4
    by_rows = {}
    for r in INCREMENTAL_ROWS:
        sel = rows_k3[:r]
        run = run3(kab.alias_build_gather_fused, sel)
        by_rows[str(r)] = {"ms": time_ms(run, 10),
                           "device_ms": device_ms(run, 20),
                           "bound_ms": bound(bytes3(r), 0)[0]}
        per_lane_line(f"alias_build_gather_fused{label} R={r}",
                      by_rows[str(r)]["ms"], by_rows[str(r)]["device_ms"])
    plain3 = time_ms(run3(ref.alias_build_gather_fused_ref, rows_k3), 2)
    b3, by3 = bound(bytes3(GATHER_ROWS), 0)
    report.append({
        "name": "alias_build_gather_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/alias_build.cu",
        "replaces": "src/repro/kernels/alias_build.py:379",
        "ms": by_rows[str(GATHER_ROWS)]["ms"],
        "device_ms": by_rows[str(GATHER_ROWS)]["device_ms"],
        "rows": GATHER_ROWS,
        "plain_ms": plain3, "bound_ms": b3, "bound_by": by3,
        "library_ms": None, "bytes": bytes3(GATHER_ROWS),
        "by_rows": by_rows, "partial_equals_full": True, **stats3})
    print(f"KERNEL alias_build_gather_fused{label} "
          f"{json.dumps(report[-1])}", flush=True)

    # Kernel 1: a slice of client 0's first chunk.
    lay = tr.layouts[0][0]
    bounds = segment.chunk_bounds(ccfg.doc_len, cfg.sorted_chunks)
    z_c = tr.locals_[0].z[:, bounds[0]:bounds[1]].reshape(-1)
    e_s = segment.sort_values(lay, z_c)
    sl = slice(0, SWEEP_SLICE)
    rows1, docs1, z01 = lay.rows[sl], lay.docs[sl], e_s[sl]
    n_dk = tr.locals_[0].n_dk
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    uni = ops._step_uniforms(gen, k, cfg.mh_steps, SWEEP_SLICE, dev)
    args1 = (prob, alias, mass, dp, shared.n_wk, shared.n_k, prior, rows1,
             docs1, z01, n_dk, *uni)
    z_kernel = kmf.mhw_sweep_fused(*args1, beta=cfg.beta, beta_bar=beta_bar)
    z_plain = mhw.sorted_chain(*args1, beta=cfg.beta, beta_bar=beta_bar)
    mismatch = float((z_kernel != z_plain).float().mean())
    # A mismatch can only come from rounding: the kernel forms the cdf of
    # the sparse weights as 32 lane blocks, each summed left to right from
    # an offset that a warp scan of the block totals gives, while the
    # plain version sums the whole row left to right
    # (core/mhw.sequential_cumsum); so a target within rounding of a cdf
    # step can land one topic apart (and the chain then continues from
    # another state), as can log() near an accept tie.  The kernel skips
    # only exact zeros, which change no sum.
    if not mismatch <= SWEEP_MISMATCH_TOL:
        raise AssertionError(f"sweep{label}: {mismatch:.3g} of chains "
                             f"differ (> {SWEEP_MISMATCH_TOL})")
    ms1 = time_ms(lambda: kmf.mhw_sweep_fused(*args1, beta=cfg.beta,
                                              beta_bar=beta_bar), 10)
    dev1 = device_ms(lambda: kmf.mhw_sweep_fused(*args1, beta=cfg.beta,
                                                 beta_bar=beta_bar), 10,
                     "mhw_sweep_kernel")
    plain1 = time_ms(lambda: mhw.sorted_chain(*args1, beta=cfg.beta,
                                              beta_bar=beta_bar), 3)
    steps = cfg.mh_steps
    cells1 = lm_word_cells(rows1, docs1, z01, n_dk, v)
    bytes1, parts1 = sweep_bytes(rows1, docs1, uni[0], v, k, k, steps,
                                 cells1, 1)
    ops_parts1 = lm_sweep_ops(rows1, docs1, n_dk, v, cells1, steps)
    ops1 = sum(ops_parts1.values())
    b1, by1 = bound(bytes1, ops1)
    # The launch the main path runs: the whole chunk.
    full_b = lay.rows.shape[0]
    uni_full = ops._step_uniforms(gen, k, steps, full_b, dev)
    cells_full = lm_word_cells(lay.rows, lay.docs, e_s, n_dk, v)
    parts_full = sweep_bytes(lay.rows, lay.docs, uni_full[0], v, k, k, steps,
                             cells_full, 1)[1]
    del uni_full
    full = full_chunk(
        "mhw_sweep_fused", lambda u: kmf.mhw_sweep_fused(
            prob, alias, mass, dp, shared.n_wk, shared.n_k, prior, lay.rows,
            lay.docs, e_s, n_dk, *u, beta=cfg.beta, beta_bar=beta_bar),
        gen, dev, k, steps, full_b, parts_full,
        lm_sweep_ops(lay.rows, lay.docs, n_dk, v, cells_full, steps),
        chunk_figures(lay.rows, lay.docs, n_dk, v), label)
    report.append({
        "name": "mhw_sweep_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/mhw_fused.cu",
        "replaces": "src/repro/kernels/mhw_fused.py:153",
        "ms": ms1, "device_ms": dev1, "plain_ms": plain1, "bound_ms": b1,
        "bound_by": by1,
        "bound_bytes_ms": bound(bytes1, 0)[0],
        "bound_ops_ms": bound(0, ops1)[0], "ops": ops1,
        "ops_parts": ops_parts1,
        "ops_note": "the LM entry at each (word, topic) cell that a token "
                    "of the word weighs; per token its document's non-zero "
                    "topics and its own; each division counted as one",
        "library_ms": None, "tokens": SWEEP_SLICE,
        "n_wk_cells": cells1, "full_chunk_n_wk_cells": cells_full,
        "mismatch_rate": mismatch,
        "max_abs_err": int((z_kernel - z_plain).abs().max()),
        "bytes": bytes1, "bytes_parts": parts1, **full})
    print(f"KERNEL mhw_sweep_fused{label} {json.dumps(report[-1])}",
          flush=True)
    return report


def clamp_check(args4, rows, shared, cfg, hyper, dev) -> dict:
    """Kernel 4 against its plain version on the same slice with a
    Stirling table that ends at half the slice's largest m_wk, so that the
    clamps bind (m to hi, s to hi+1 in the same-table ratio and to hi in
    the new-table ratio, with hi = n_max − 1) and the table's −1e30
    entries are reached: the state's counts stay below the main path's
    n_max = 512."""
    from repro_torch.core import pdp, stirling
    from repro_torch.kernels import mhw_fused as kmf

    words = torch.unique(rows[rows < cfg.vocab_size].long())
    m_w, s_w = shared.m_wk[words], shared.s_wk[words]
    n_max = max(2, int(m_w.max()) // 2)
    hi = n_max - 1
    small = stirling.as_tensor(n_max, cfg.discount, dev)
    args = (*args4[:8], small, *args4[9:])      # stirl is the ninth
    e_kernel = kmf.pdp_sweep_fused(*args, **hyper)
    e_plain = pdp.sorted_chain_pdp(*args, **hyper)
    mismatch = float((e_kernel != e_plain).float().mean())
    out = {"stirling_n_max": n_max,
           "cells_m_above_hi": int((m_w > hi).sum()),
           "cells_s_above_hi": int((s_w > hi).sum()),
           "words_clamped": int((m_w > hi).any(1).sum()),
           "mismatch_rate": mismatch}
    print(f"PDP sweep with clamped Stirling ratios {json.dumps(out)}",
          flush=True)
    if not mismatch <= SWEEP_MISMATCH_TOL:
        raise AssertionError(f"PDP sweep at n_max={n_max}: {mismatch:.3g} "
                             f"of chains differ (> {SWEEP_MISMATCH_TOL})")
    return out


def pdp_kernels(dev, tr, cfg, ccfg, report2: dict) -> list[dict]:
    """Phase 5: the alias build at width 2K (added to ``report2``, kernel
    2's entry) and kernels 5 and 4 against their plain versions."""
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import pdp, stirling
    from repro_torch.data import segment
    from repro_torch.kernels import alias_build as kab
    from repro_torch.kernels import mhw_fused as kmf
    from repro_torch.kernels import ops

    v, k = cfg.vocab_size, cfg.n_topics
    e_out = 2 * k
    fam = tr.family
    shared = tr.shared
    dp = pdp.dense_probs(cfg, shared)
    report = []
    above = int((shared.m_wk > cfg.stirling_n_max).sum())
    print(f"PDP cells with m_wk above stirling_n_max={cfg.stirling_n_max}: "
          f"{above}; max m_wk {float(shared.m_wk.max())}")

    # Kernel 2 at width 2K on the full (V, 2K) dense term.
    prob, alias, mass = kab.alias_build(dp)
    prob_r, alias_r, mass_r = alias_mod.build(dp)
    stats2 = check_tables("alias_build (2K)", dp, prob, alias, mass, prob_r,
                          alias_r, mass_r)
    del prob_r, alias_r, mass_r
    ms2 = time_ms(lambda: kab.alias_build(dp), 5)
    dev2 = device_ms(lambda: kab.alias_build(dp), 5)
    plain2 = time_ms(lambda: alias_mod.build(dp), 2)
    bytes2 = v * e_out * 12 + v * 4
    b2, by2 = bound(bytes2, 0)
    report2["width_2k"] = {"rows": v, "width": e_out, "ms": ms2,
                           "device_ms": dev2,
                           "plain_ms": plain2, "bound_ms": b2,
                           "bound_by": by2, "bytes": bytes2, **stats2}
    print(f"KERNEL alias_build width 2K {json.dumps(report2['width_2k'])}",
          flush=True)
    per_lane_line("alias_build width 2K", ms2)

    # Kernel 5: the R rows with the largest m_wk + s_wk mass.
    rows5 = torch.argsort(-(shared.m_wk + shared.s_wk).sum(1), stable=True)[
        :GATHER_ROWS].to(torch.int32)
    ridx = rows5.long()
    p_rows = fam.dense_probs_rows(cfg, shared, rows5)
    if not torch.equal(p_rows, dp[ridx]):
        raise AssertionError("PDP gathered dense rows differ from the full "
                             "dense term's rows")
    t5 = kab.alias_build_rows(p_rows)
    t5_r = alias_mod.build(p_rows)
    if not all(torch.equal(a, b) for a, b in zip(t5, t5_r)):
        raise AssertionError("alias_build_rows differs from its plain "
                             "version")
    if not (torch.equal(t5[0], prob[ridx]) and torch.equal(t5[1], alias[ridx])
            and torch.equal(t5[2], mass[ridx])):
        raise AssertionError("alias_build_rows differs from the full "
                             "build's rows")
    stats5 = check_tables("alias_build_rows", p_rows, *t5, *t5_r)

    def bytes5(r):
        # Reads the (R, 2K) block; writes prob and alias (R, 2K) and mass.
        return r * e_out * 12 + r * 4
    by_rows = {}
    for r in INCREMENTAL_ROWS:
        block = p_rows[:r]
        run = functools.partial(kab.alias_build_rows, block)
        by_rows[str(r)] = {"ms": time_ms(run, 10),
                           "device_ms": device_ms(run, 20),
                           "bound_ms": bound(bytes5(r), 0)[0]}
        per_lane_line(f"alias_build_rows R={r}", by_rows[str(r)]["ms"],
                      by_rows[str(r)]["device_ms"])
    plain5 = time_ms(lambda: alias_mod.build(p_rows), 2)
    b5, by5 = bound(bytes5(GATHER_ROWS), 0)
    report.append({
        "name": "alias_build_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/alias_build.cu",
        "replaces": "src/repro/kernels/alias_build.py:336",
        "ms": by_rows[str(GATHER_ROWS)]["ms"],
        "device_ms": by_rows[str(GATHER_ROWS)]["device_ms"],
        "plain_ms": plain5,
        "bound_ms": b5, "bound_by": by5, "library_ms": None,
        "bytes": bytes5(GATHER_ROWS), "rows": GATHER_ROWS, "width": e_out,
        "by_rows": by_rows, "partial_equals_full": True,
        "adversarial": adversarial_check("alias_build_rows", dev),
        **stats5})
    print(f"KERNEL alias_build_rows {json.dumps(report[-1])}", flush=True)

    # Kernel 4: a slice of client 0's first chunk.
    lay = tr.layouts[0][0]
    bounds = segment.chunk_bounds(ccfg.doc_len, cfg.sorted_chunks)
    e_c = fam.encode(cfg, tr.locals_[0])[:, bounds[0]:bounds[1]].reshape(-1)
    e_s = segment.sort_values(lay, e_c)
    sl = slice(0, PDP_SWEEP_SLICE)
    rows4, docs4, e04 = lay.rows[sl], lay.docs[sl], e_s[sl]
    n_dk = tr.locals_[0].n_dk
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    uni = ops._step_uniforms(gen, e_out, cfg.mh_steps, PDP_SWEEP_SLICE, dev)
    stirl = stirling.as_tensor(cfg.stirling_n_max, cfg.discount, dev)
    prior = fam.sparse_prior(cfg, shared)
    hyper = dict(b=cfg.concentration, a=cfg.discount, gamma=cfg.gamma,
                 gamma_bar=cfg.gamma * v)
    tabs = (prob, alias, mass, dp, shared.m_wk, shared.s_wk, shared.m_k,
            shared.s_k, stirl, prior)
    args4 = (*tabs, rows4, docs4, e04, n_dk, *uni)
    e_kernel = kmf.pdp_sweep_fused(*args4, **hyper)
    e_plain = pdp.sorted_chain_pdp(*args4, **hyper)
    mismatch = float((e_kernel != e_plain).float().mean())
    # As for the LDA sweep: only the kernel's 32-block cdf (against the
    # plain version's left-to-right sum) and log() near an accept tie
    # can make a chain differ.
    if not mismatch <= SWEEP_MISMATCH_TOL:
        raise AssertionError(f"PDP sweep: {mismatch:.3g} of chains differ "
                             f"(> {SWEEP_MISMATCH_TOL})")
    if not bool(((e_kernel >= 0) & (e_kernel < e_out)).all()):
        raise AssertionError("PDP sweep: outcome out of [0, 2K)")
    moved = float((e_kernel != e04).float().mean())
    max_err4 = int((e_kernel - e_plain).abs().max())
    del e_plain
    torch.cuda.empty_cache()
    clamp = clamp_check(args4, rows4, shared, cfg, hyper, dev)
    ms4 = time_ms(lambda: kmf.pdp_sweep_fused(*args4, **hyper), 10)
    dev4 = device_ms(lambda: kmf.pdp_sweep_fused(*args4, **hyper), 10,
                     "pdp_sweep_kernel")
    plain4 = time_ms(lambda: pdp.sorted_chain_pdp(*args4, **hyper), 2)
    torch.cuda.empty_cache()
    steps = cfg.mh_steps
    m_cells, nnz4 = pdp_word_cells(rows4, shared.m_wk, v)
    bytes4, parts4 = sweep_bytes(rows4, docs4, uni[0], v, k, e_out, steps,
                                 m_cells + nnz4, 2)
    stirl_bytes = stirl.numel() * 4
    bytes4 += stirl_bytes
    parts4["stirling_table"] = stirl_bytes
    ops_parts4 = pdp_sweep_ops(rows4, docs4, n_dk, v, k, nnz4, steps)
    ops4 = sum(ops_parts4.values())
    b4, by4 = bound(bytes4, ops4)
    # The launch the main path runs: the whole chunk.
    full_b = lay.rows.shape[0]
    uni_full = ops._step_uniforms(gen, e_out, steps, full_b, dev)
    m_full, nnz_full = pdp_word_cells(lay.rows, shared.m_wk, v)
    parts_full = sweep_bytes(lay.rows, lay.docs, uni_full[0], v, k, e_out,
                             steps, m_full + nnz_full, 2)[1]
    parts_full["stirling_table"] = stirl_bytes
    del uni_full
    full = full_chunk(
        "pdp_sweep_fused", lambda u: kmf.pdp_sweep_fused(
            *tabs, lay.rows, lay.docs, e_s, n_dk, *u, **hyper),
        gen, dev, e_out, steps, full_b, parts_full,
        pdp_sweep_ops(lay.rows, lay.docs, n_dk, v, k, nnz_full, steps),
        chunk_figures(lay.rows, lay.docs, n_dk, v), "")
    report.append({
        "name": "pdp_sweep_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/pdp_fused.cu",
        "replaces": "src/repro/kernels/mhw_fused.py:322",
        "ms": ms4, "device_ms": dev4, "plain_ms": plain4, "bound_ms": b4,
        "bound_by": by4,
        "bound_bytes_ms": bound(bytes4, 0)[0],
        "bound_ops_ms": bound(0, ops4)[0], "ops": ops4,
        "ops_parts": ops_parts4,
        "ops_note": "the word factors once per non-zero (word, topic) cell "
                    "of the slice and once per topic for the empty cells; "
                    "per token its document's non-zero topics and its own; "
                    "each log and exp counted as one",
        "library_ms": None, "tokens": PDP_SWEEP_SLICE,
        "m_wk_cells": m_cells, "s_wk_cells": nnz4,
        "full_chunk_m_wk_cells": m_full, "full_chunk_s_wk_cells": nnz_full,
        "mismatch_rate": mismatch, "moved_share": moved,
        "clamp_check": clamp,
        "max_abs_err": max_err4,
        "bytes": bytes4, "bytes_parts": parts4, **full})
    print(f"KERNEL pdp_sweep_fused {json.dumps(report[-1])}", flush=True)
    return report


def fused_kernel(tr, cfg) -> dict:
    """Phase 9: kernel 6, the fused LDA build, against its plain version
    on the trainer's statistics, and kernel 2 on the unfused term of the
    same statistics, timed beside it."""
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lda
    from repro_torch.kernels import alias_build as kab
    from repro_torch.kernels import ops, ref

    v, k = cfg.vocab_size, cfg.n_topics
    shared = tr.shared
    hyper = dict(alpha=cfg.alpha, beta=cfg.beta, vocab_size=v)
    args = (shared.n_wk, shared.n_k)

    def run6():
        return kab.alias_build_fused(*args, alpha=cfg.alpha, beta=cfg.beta,
                                     beta_bar=cfg.beta * v)
    prob, alias, mass = run6()
    p = ref.fused_dense_ref(*args, **hyper)
    stats6 = check_tables("alias_build_fused", p, prob, alias, mass,
                          *alias_mod.build(p))
    tables, stale = ops.build_tables_fused_lda(*args, **hyper,
                                               device=shared.n_wk.device)
    if not (torch.equal(stale, p) and torch.equal(tables.prob, prob)
            and torch.equal(tables.alias, alias)
            and torch.equal(tables.mass, mass)):
        raise AssertionError("build_tables_fused_lda: stale or tables "
                             "differ from the fused formula's")
    del tables, stale
    # The grouping trap: the product first is not lda.dense_probs, so the
    # fused term and tables are not the unfused ones.
    dp = lda.dense_probs(cfg, shared)
    prob2, alias2, _ = kab.alias_build(dp)
    grouping = {
        "stale_entries_differing_from_unfused": int((p != dp).sum()),
        "rows_whose_tables_differ_from_unfused": int(
            ((prob2 != prob) | (alias2 != alias)).any(1).sum())}
    del prob2, alias2
    ms6 = time_ms(run6, 5)
    dev6 = device_ms(run6, 5)
    ms2 = time_ms(lambda: kab.alias_build(dp), 5)
    del dp
    plain6 = time_ms(lambda: ref.alias_build_fused_ref(*args, **hyper), 2)
    # Reads n_wk (V, K) and n_k; writes prob and alias (V, K) and mass.
    bytes6 = v * k * 12 + v * 4 + k * 4
    b6, by6 = bound(bytes6, 0)
    entry = {
        "name": "alias_build_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/alias_build.cu",
        "replaces": "src/repro/kernels/alias_build.py:273",
        "ms": ms6, "device_ms": dev6, "plain_ms": plain6, "bound_ms": b6,
        "bound_by": by6,
        "library_ms": None, "bytes": bytes6,
        "bytes_parts": {"n_wk": v * k * 4, "n_k": k * 4,
                        "prob_alias": v * k * 8, "mass": v * 4},
        "alias_build_unfused_ms": ms2, "grouping": grouping,
        "adversarial": adversarial_check("alias_build_fused",
                                         shared.n_wk.device), **stats6}
    print(f"KERNEL alias_build_fused {json.dumps(entry)}", flush=True)
    per_lane_line("alias_build_fused", ms6)
    return entry


def draw_inputs(dev, tr, cfg, ccfg) -> dict:
    """The draws path's inputs: client 0's first sorted chunk that has
    masked tail positions (the layout's sentinels) of the LDA trainer
    ``tr``, with its tables and stale matrix; seeded slots, coins and
    accept uniforms; the same draws shuffled (``*_sh``, by ``perm``); and a
    Metropolis step whose candidate is the slot draw (a uniform proposal,
    so log q = −log K at both states) against the stale row as target, log
    p at (row, slot) and (row, z)."""
    from repro_torch.data import segment

    v, k = cfg.vocab_size, cfg.n_topics
    chunk = next(c for c, lay in enumerate(tr.layouts[0])
                 if bool((lay.rows >= v).any()))
    lay = tr.layouts[0][chunk]
    tables, stale = tr.pstate.tables, tr.pstate.stale
    rows = lay.rows
    b = rows.shape[0]
    bounds = segment.chunk_bounds(ccfg.doc_len, cfg.sorted_chunks)
    z = segment.sort_values(
        lay, tr.locals_[0].z[:, bounds[chunk]:bounds[chunk + 1]].reshape(-1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    slot = torch.randint(0, k, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    coin = torch.rand(b, generator=gen, device=dev)
    u = torch.rand(b, generator=gen, device=dev)
    perm = torch.randperm(b, generator=gen, device=dev)
    r = rows.clamp_max(v - 1).long()
    return {"lay": lay, "tables": tables, "rows": rows, "slot": slot,
            "coin": coin, "u": u, "perm": perm, "z": z, "r": r,
            "real": rows < v,
            "lp_c": torch.log(stale[r, slot.long()] + 1e-30),
            "lp_z": torch.log(stale[r, z.long()] + 1e-30),
            "lq": torch.full((b,), -math.log(k), device=dev),
            "rows_sh": rows[perm], "slot_sh": slot[perm],
            "coin_sh": coin[perm]}


def draw_bytes(inp: dict, k: int) -> tuple[dict, dict]:
    """Bytes the draws of kernels 7 and 8 must move, and the bytes a card
    with 32-byte sectors moves at least.  The first: rows and the result
    for every position; slot and coin for real draws (a sentinel's result
    is 0 without them); prob at each distinct (row, slot) entry the real
    draws name, and alias at those where the coin took the alias.  The
    second: the same streams, and 32 bytes for each distinct sector of
    those prob and alias entries."""
    b, real = inp["rows"].shape[0], inp["real"]
    n_real = int(real.sum())
    key = inp["r"][real] * k + inp["slot"][real].long()
    took_alias = ~(inp["coin"][real] < inp["tables"].prob.view(-1)[key])
    streams = {"rows_out": b * 8, "slot_coin": n_real * 8}
    parts = dict(streams,
                 prob_points=int(torch.unique(key).numel()) * 4,
                 alias_points=int(torch.unique(key[took_alias]).numel()) * 4)
    sectors = dict(streams,
                   prob_sectors=int(torch.unique(key // 8).numel()) * 32,
                   alias_sectors=int(torch.unique(
                       key[took_alias] // 8).numel()) * 32)
    return parts, sectors


def draw_kernels(dev, tr, cfg, ccfg) -> tuple[list, dict]:
    """Phase 10, the draws path: kernels 7, 8 and 9 through their ``ops``
    entry points on ``draw_inputs``: sorted draws (kernel 7), the same
    draws shuffled (kernel 8), and a Metropolis step (kernel 9).  The
    counters are zeroed just before and read just after; then each kernel
    is held against its plain version and timed, as a call and on the
    device's clock."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import alias_sample as kas
    from repro_torch.kernels import mh_accept as kma

    k = cfg.n_topics
    inp = draw_inputs(dev, tr, cfg, ccfg)
    lay, tables = inp["lay"], inp["tables"]
    rows, slot, coin, u, z = (inp[n] for n in ("rows", "slot", "coin", "u",
                                               "z"))
    rows_sh, slot_sh, coin_sh = inp["rows_sh"], inp["slot_sh"], inp["coin_sh"]
    lp_c, lp_z, lq, perm, real = (inp[n] for n in ("lp_c", "lp_z", "lq",
                                                   "perm", "real"))
    b = rows.shape[0]
    n_real = int(real.sum())
    torch.cuda.synchronize()

    _build.reset_launches()
    d7 = ops.sample_rows_sorted(tables, rows, lay.vstart, lay.vcount,
                                tile_b=cfg.tile_b, uniforms=(slot, coin),
                                device=dev)
    d8 = ops.sample_rows(tables, rows_sh, uniforms=(slot_sh, coin_sh),
                         device=dev)
    z9 = ops.mh_accept(z, slot, lp_z, lp_c, lq, lq, u=u, device=dev)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    for name in ("alias_sample_sorted", "alias_sample", "mh_accept"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"{name} never launched on the draws path")

    want7 = ref.alias_sample_sorted_ref(tables.prob, tables.alias, rows,
                                        slot, coin)
    want8 = ref.alias_sample_ref(tables.prob, tables.alias, rows_sh, slot_sh,
                                 coin_sh)
    if not (torch.equal(d7, want7) and torch.equal(d8, want8)
            and torch.equal(d8, d7[perm])):
        raise AssertionError(
            f"draws: {int((d7 != want7).sum())} sorted and "
            f"{int((d8 != want8).sum())} shuffled draws differ from plain")
    if not bool((d7[~real] == 0).all()):
        raise AssertionError("draws: a sentinel row drew a non-zero topic")
    want9 = ref.mh_accept_ref(z, slot, lp_z, lp_c, lq, lq, u)
    differ = z9 != want9
    n_differ = int(differ.sum())
    if n_differ:
        # Only the log can round apart: the kernel's logf against the
        # plain version's torch.log; the rest is the same float32
        # subtractions in the same order.  A state may differ only where
        # log(u + 1e-30) lies within an ulp of the log ratio.
        ratio = ((lp_c - lp_z) + lq) - lq
        lu = torch.log(u + 1e-30)
        near = (lu - ratio).abs() <= 2 * torch.finfo(torch.float32).eps * \
            ratio.abs().clamp_min(1.0)
        print(f"MH accept: {n_differ} of {b} states differ from plain, "
              f"{int((differ & near).sum())} of them at an accept tie")
        if not bool(near[differ].all()):
            raise AssertionError(f"mh_accept: {n_differ} states differ, not "
                                 "all at a log rounding tie")

    parts, sector_parts = draw_bytes(inp, k)
    bytes78 = sum(parts.values())
    b78, by78 = bound(bytes78, 0)
    sector78 = sum(sector_parts.values())
    bytes9 = b * 32                     # seven 4-byte inputs, one output
    b9, by9 = bound(bytes9, 0)
    calls = {
        "alias_sample_sorted": lambda: kas.alias_sample_sorted(
            tables.prob, tables.alias, rows, slot, coin),
        "alias_sample": lambda: kas.alias_sample(
            tables.prob, tables.alias, rows_sh, slot_sh, coin_sh),
        "mh_accept": lambda: kma.mh_accept(z, slot, lp_z, lp_c, lq, lq, u)}
    symbols = {"alias_sample_sorted": "alias_sample_sorted_kernel",
               "alias_sample": "alias_sample_batch_kernel",
               "mh_accept": "mh_accept_kernel"}
    timed = {n: {"ms": time_ms(fn, 20),
                 "device_ms": device_ms(fn, 20, symbols[n])}
             for n, fn in calls.items()}
    plain7 = time_ms(lambda: ref.alias_sample_sorted_ref(
        tables.prob, tables.alias, rows, slot, coin), 5)
    plain8 = time_ms(lambda: ref.alias_sample_ref(
        tables.prob, tables.alias, rows_sh, slot_sh, coin_sh), 5)
    plain9 = time_ms(lambda: ref.mh_accept_ref(z, slot, lp_z, lp_c, lq, lq,
                                               u), 5)
    common = {"route": "cuda", "library_ms": None, "draws": b,
              "real_draws": n_real}
    sectors = {"bytes": bytes78, "bytes_parts": parts,
               "sector_bytes": sector78, "sector_bytes_parts": sector_parts,
               "sector_ms": bound(sector78, 0)[0]}
    report = [
        {"name": "alias_sample_sorted",
         "source": "src/repro_torch/csrc/alias_sample.cu",
         "replaces": "src/repro/kernels/alias_sample.py:137",
         **timed["alias_sample_sorted"], "plain_ms": plain7,
         "bound_ms": b78, "bound_by": by78, **sectors, "max_abs_err": 0,
         "sentinels_zero": b - n_real, **common},
        {"name": "alias_sample",
         "source": "src/repro_torch/csrc/alias_sample.cu",
         "replaces": "src/repro/kernels/alias_sample.py:71",
         **timed["alias_sample"], "plain_ms": plain8,
         "bound_ms": b78, "bound_by": by78, **sectors, "max_abs_err": 0,
         "input": "the sorted draws shuffled", **common},
        {"name": "mh_accept",
         "source": "src/repro_torch/csrc/mh_accept.cu",
         "replaces": "src/repro/kernels/mh_accept.py:36",
         **timed["mh_accept"], "plain_ms": plain9,
         "bound_ms": b9, "bound_by": by9,
         "bytes": bytes9, "bytes_parts": {"inputs": b * 28, "out": b * 4},
         "states_differing": n_differ,
         "max_abs_err": int((z9 - want9).abs().max()),
         "accepted_share": float((z9 == slot).float().mean()), **common}]
    for entry in report:
        print(f"KERNEL {entry['name']} {json.dumps(entry)}", flush=True)
    return report, counts


# ---------------------------------------------------------------------------
# Serving paths (phases 4s, 6s, 8s, 9s and the launcher)
# ---------------------------------------------------------------------------

def restore_counts(saved: dict) -> None:
    """Put the launch counters back to ``saved``: launches made to check a
    path, not to drive it, are left out of its counts."""
    from repro_torch.kernels import _build
    _build.LAUNCHES.clear()
    _build.LAUNCHES.update(saved)


def serve_requests(phi, n_docs: int, seed: int):
    """Requests of ``held_out_docs`` documents, request seeds 1000+i."""
    from repro_torch.serve import InferRequest
    tokens, mask = held_out_docs(phi, n_docs, SERVE["max_len"], seed=seed)
    lens = mask.sum(1)
    return [InferRequest(uid=i, tokens=tokens[i, :lens[i]], seed=1000 + i)
            for i in range(n_docs)]


def drive_engine(eng, reqs) -> tuple[dict, dict]:
    """``FoldInEngine.run`` with each step timed: CUDA events around it
    (the span on the device's queue) and the host's clock (the time the
    host takes to enqueue it; nothing in a step syncs)."""
    events, host_ms, results = [], [], {}
    queue = list(reqs)
    t0 = time.perf_counter()
    while queue or eng.live:
        while queue and eng.admit(queue[0]):
            queue.pop(0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        th = time.perf_counter()
        eng.step()
        host_ms.append((time.perf_counter() - th) * 1e3)
        end.record()
        events.append((start, end))
        for res in eng.harvest():
            results[res.uid] = res
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in events]
    return results, {
        "docs": len(results), "steps": len(step_ms),
        "wall_s": wall, "docs_per_s": len(results) / wall,
        "step_ms_median": statistics.median(step_ms),
        "step_ms_max": max(step_ms),
        "step_host_ms_median": statistics.median(host_ms)}


def profile_step(snap, reqs) -> dict:
    """One engine step with every slot live, under torch.profiler after a
    step of warm-up: the step's wall time, the device's busy time in it
    (its kernels and copies, on the device's clock) and their costliest
    entries, and the host's calls of the kind that launch work."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import FoldInEngine, ServeConfig
    cuda = torch.autograd.DeviceType.CUDA
    eng = FoldInEngine(snap, ServeConfig(**SERVE))
    for req in reqs[:SERVE["max_slots"]]:
        eng.admit(req)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name: dict[str, list] = {}
    launches = 0
    for e in prof.events():
        if e.device_type == cuda:
            row = by_name.setdefault(e.name[:60], [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC"):
            launches += 1
    rows = sorted(((ms, n, k) for k, (ms, n) in by_name.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms),
            "device_entries": sum(r[1] for r in rows),
            "host_launch_calls": launches, "slots": eng.live,
            "top": [[round(ms, 4), n, k] for ms, n, k in rows[:6]]}


def check_results(label, snap, reqs, results) -> None:
    k = snap.n_topics
    for req in reqs:
        res = results[req.uid]
        if not (abs(float(res.theta.sum()) - 1.0) <= 1e-4
                and res.theta.shape == (k,)
                and res.assignments.shape == (len(req.tokens),)
                and ((res.assignments >= 0) & (res.assignments < k)).all()
                and np.isfinite(res.theta).all()):
            raise AssertionError(f"{label}: result {req.uid} malformed "
                                 f"(theta sums to {res.theta.sum()})")


def check_oracle(label, snap, reqs, results, n_check: int) -> int:
    """``n_check`` documents, spread over the run, bit-equal (assignments
    and theta) to ``reference_fold_in`` on the card; and the first one the
    same alone as in the pooled run."""
    from repro_torch.serve import FoldInEngine, ServeConfig, reference_fold_in
    picks = np.linspace(0, len(reqs) - 1, n_check).astype(int)
    for i in picks:
        req = reqs[i]
        _, theta, z = reference_fold_in(snap, req.tokens, req.seed,
                                        n_sweeps=SERVE["n_sweeps"],
                                        max_len=SERVE["max_len"])
        got = results[req.uid]
        if not (np.array_equal(got.assignments, z)
                and np.array_equal(got.theta, theta)):
            raise AssertionError(
                f"{label}: document {req.uid} differs from reference_fold_in"
                f" ({int((got.assignments != z).sum())} of {z.size} "
                "assignments)")
    solo = FoldInEngine(snap, ServeConfig(**SERVE)).run([reqs[picks[-1]]])
    res = results[reqs[picks[-1]].uid]
    if not (np.array_equal(solo[res.uid].assignments, res.assignments)
            and np.array_equal(solo[res.uid].theta, res.theta)):
        raise AssertionError(f"{label}: a document alone differs from the "
                             "same document in the pooled run")
    return len(picks)


def serve_chunk_check(snap, reqs) -> dict:
    """The sweep kernel of the family at the serving grid's shape (one
    chunk of ``max_slots`` documents), held against its plain version on
    the same inputs and timed beside it, with the list build first."""
    from repro_torch.core import mhw, pdp, stirling
    from repro_torch.data import segment
    from repro_torch.kernels import ops
    fam, cfg = snap.family, snap.cfg
    s, l = SERVE["max_slots"], SERVE["max_len"]
    dev = snap.device
    tok = torch.zeros((s, l), dtype=torch.int32, device=dev)
    mask = torch.zeros((s, l), dtype=torch.bool, device=dev)
    for j, req in enumerate(reqs[:s]):
        tok[j, :len(req.tokens)] = torch.as_tensor(req.tokens)
        mask[j, :len(req.tokens)] = True
    local, _ = fam.init_state(cfg, tok, mask, (7,))
    lay = fam.build_sorted_layouts(cfg, tok, mask)[0]
    e_out = fam.n_outcomes(cfg)
    clen = l // cfg.sorted_chunks
    e0 = segment.sort_values(lay, fam.encode(cfg, local)[:, :clen]
                             .reshape(-1), fill=0)
    gen = torch.Generator(device=dev).manual_seed(5)
    uni = ops._step_uniforms(gen, e_out, cfg.mh_steps, lay.rows.shape[0],
                             dev)
    sh, t = snap.shared, snap.tables
    if fam.name == "pdp":
        stirl = stirling.as_tensor(cfg.stirling_n_max, cfg.discount, dev)
        hyper = dict(b=cfg.concentration, a=cfg.discount, gamma=cfg.gamma,
                     gamma_bar=cfg.gamma * cfg.vocab_size)
        args = (*t, snap.stale, sh.m_wk, sh.s_wk, sh.m_k, sh.s_k, stirl,
                fam.sparse_prior(cfg, sh), lay.rows, lay.docs, e0,
                local.n_dk, *uni)
        from repro_torch.kernels.mhw_fused import pdp_sweep_fused as kern
        plain, name = pdp.sorted_chain_pdp, "pdp_sweep_fused"
    else:
        hyper = dict(beta=cfg.beta, beta_bar=cfg.beta * cfg.vocab_size)
        args = (*t, snap.stale, sh.n_wk, sh.n_k, fam.sparse_prior(cfg, sh),
                lay.rows, lay.docs, e0, local.n_dk, *uni)
        from repro_torch.kernels.mhw_fused import mhw_sweep_fused as kern
        plain, name = mhw.sorted_chain, "mhw_sweep_fused"
    got = kern(*args, **hyper)
    want = plain(*args, **hyper)
    mismatch = float((got != want).float().mean())
    if not mismatch <= SWEEP_MISMATCH_TOL:
        raise AssertionError(f"{fam.name} serve chunk: {mismatch:.2e} of "
                             f"chains differ (> {SWEEP_MISMATCH_TOL})")
    v, k, steps = cfg.vocab_size, cfg.n_topics, cfg.mh_steps
    if fam.name == "pdp":
        cells, nnz = pdp_word_cells(lay.rows, sh.m_wk, v)
        nbytes = sweep_bytes(lay.rows, lay.docs, uni[0], v, k, e_out, steps,
                             cells + nnz, 2)[0] + stirl.numel() * 4
        nops = sum(pdp_sweep_ops(lay.rows, lay.docs, local.n_dk, v, k, nnz,
                                 steps).values())
    else:
        cells = lm_word_cells(lay.rows, lay.docs, e0, local.n_dk, v)
        nbytes = sweep_bytes(lay.rows, lay.docs, uni[0], v, k, k, steps,
                             cells, 1)[0]
        nops = sum(lm_sweep_ops(lay.rows, lay.docs, local.n_dk, v, cells,
                                steps).values())
    b, by = bound(nbytes, nops)
    return {"positions": int(lay.rows.shape[0]),
            "real": int((lay.rows < cfg.vocab_size).sum()), "docs": s,
            "mismatch_share": mismatch,
            "ms": time_ms(lambda: kern(*args, **hyper), 20),
            "device_ms": device_ms(lambda: kern(*args, **hyper), 10,
                                   SWEEP_SYMBOLS[name]),
            "plain_ms": time_ms(lambda: plain(*args, **hyper), 3),
            "bound_ms": b, "bound_by": by, "bytes": nbytes, "ops": nops,
            "figures": chunk_figures(lay.rows, lay.docs, local.n_dk, v)}


def serve_over_tcp(snap, card) -> dict:
    """4 client threads × 32 documents of ``requests_for`` against an
    ``InferenceServer`` on 127.0.0.1; each checksum must equal the
    in-process engine's; one out-of-vocabulary request gets an ERROR, and
    the service answers after it; the batcher must be alive at the end."""
    import threading

    from repro_torch.kernels import _build
    from repro_torch.net.protocol import ProtocolError
    from repro_torch.serve import FoldInEngine, ServeConfig, result_checksum
    from repro_torch.serve.client import InferenceClient, requests_for
    from repro_torch.serve.server import InferenceServer

    v = snap.vocab_size
    parts = [requests_for(c, vocab_size=v, n_docs=32,
                          max_len=SERVE["max_len"], corpus_seed=7,
                          seed_base=1000) for c in range(4)]
    srv = InferenceServer(snap, ServeConfig(**SERVE), max_queue=128).start()
    addr = "%s:%d" % srv.address
    got, lat_ms, errors = {}, [], []
    lock = threading.Lock()

    def client(part):
        try:
            with InferenceClient(addr, timeout=600.0) as cli:
                for r in part:
                    t0 = time.perf_counter()
                    res = cli.infer(r.uid, r.tokens, seed=r.seed)
                    with lock:
                        lat_ms.append((time.perf_counter() - t0) * 1e3)
                        got[res.uid] = result_checksum(res)
        except Exception as e:          # any ERROR here was not asked for
            with lock:
                errors.append(f"{type(e).__name__}: {e}")

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(p,))
                   for p in parts]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        oov = None
        with InferenceClient(addr, timeout=60.0) as cli:
            try:
                cli.infer(99_999, np.asarray([v], np.int32))
            except ProtocolError as e:
                oov = str(e)
        if oov is None or "out of range" not in oov:
            raise AssertionError(f"out-of-vocabulary request: {oov!r}")
        after = parts[0][0]
        with InferenceClient(addr, timeout=600.0) as cli:
            again = cli.infer(after.uid, after.tokens, seed=after.seed)
        stats = srv.stats()
        alive = srv.batcher_alive
    finally:
        srv.close()
    if errors:
        raise AssertionError(f"TCP clients got errors: {errors[:3]}")
    if not alive or stats["batcher_error"] is not None:
        raise AssertionError(f"batcher dead: {stats['batcher_error']}")
    saved = dict(_build.LAUNCHES)
    want = FoldInEngine(snap, ServeConfig(**SERVE)).run(
        [r for p in parts for r in p])
    restore_counts(saved)
    want = {uid: result_checksum(res) for uid, res in want.items()}
    if got != want or result_checksum(again) != want[after.uid]:
        bad = sum(got.get(u) != w for u, w in want.items())
        raise AssertionError(f"TCP: {bad} of {len(want)} checksums differ "
                             "from the in-process engine")
    lat = sorted(lat_ms)
    return {"docs": len(got), "clients": 4, "wall_s": wall,
            "docs_per_s": len(got) / wall,
            "latency_p50_ms": lat[len(lat) // 2],
            "latency_p99_ms": lat[min(len(lat) - 1,
                                      int(round(0.99 * (len(lat) - 1))))],
            "shed": stats["shed"], "sweeps_run": stats["sweeps_run"],
            "oov_error": oov[:80], "bit_equal_to_engine": True,
            "card": card}


def checkpoint_round_trip(tr, snap) -> dict:
    """``save_snapshot`` at full width into the ignored ``build/``, then
    ``from_checkpoint``: shared statistics bit-equal to ``trainer.shared``
    and tables equal to ``from_trainer``'s; the directory is deleted."""
    import dataclasses
    import shutil

    from repro_torch.serve import from_checkpoint
    d = ROOT / "build" / "serve_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    tr.tcfg = dataclasses.replace(tr.tcfg, snapshot_dir=str(d))
    try:
        t = time.perf_counter()
        path = tr.save_snapshot()
        save_s = time.perf_counter() - t
        size = Path(path).stat().st_size
        t = time.perf_counter()
        back = from_checkpoint(str(d), tr.cfg)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        shared = tr.shared
        same = all(torch.equal(a, b) for a, b in zip(back.shared, shared))
        tables = all(torch.equal(a, b) for a, b in
                     zip((*back.tables, back.stale),
                         (*snap.tables, snap.stale)))
        del back
    finally:
        shutil.rmtree(d, ignore_errors=True)
        tr.tcfg = dataclasses.replace(tr.tcfg, snapshot_dir=None)
    if not (same and tables):
        raise AssertionError(f"checkpoint round trip: shared equal {same}, "
                             f"tables equal {tables}")
    return {"file_bytes": size, "save_s": save_s, "load_s": load_s,
            "shared_bit_equal": True, "tables_equal": True}


def serve_path(label, tr, phi, n_docs, n_check, card, *, ho=None,
               tcp=False, ckpt=False) -> dict:
    """Drive one serving path from a trained model: freeze (kernel 2, or 6
    for the fused LDA), fold ``n_docs`` documents in (the list build and
    kernel 1, or 4 for PDP, once a chunk a step), and for LDA the held-out
    documents and the TCP service too.  The counters are zeroed just
    before and read just after; checks that launch kernels to compare are
    left out of them."""
    from repro_torch.kernels import _build
    from repro_torch.serve import (FoldInEngine, InferRequest, ServeConfig,
                                   fold_in_perplexity, from_trainer)

    cfg, fam = tr.cfg, tr.family
    sweep = "pdp_sweep_fused" if fam.name == "pdp" else "mhw_sweep_fused"
    full = ("alias_build_fused" if getattr(cfg, "fused_alias_build", False)
            else "alias_build")
    reqs = serve_requests(phi, n_docs, seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t = time.perf_counter()
    snap = from_trainer(tr)
    torch.cuda.synchronize()
    freeze_s = time.perf_counter() - t
    eng = FoldInEngine(snap, ServeConfig(**SERVE))
    results, summary = drive_engine(eng, reqs)
    launched = dict(_build.LAUNCHES)
    want = eng.sweeps_run * cfg.sorted_chunks
    if (launched.get(sweep, 0) != want
            or launched.get("doc_topic_lists", 0) != want
            or launched.get(full, 0) < 1):
        raise AssertionError(f"{label}: launches {launched}, expected "
                             f"{sweep} and doc_topic_lists {want} times "
                             f"and {full} at least once")
    summary.update(freeze_s=freeze_s, sweeps=SERVE["n_sweeps"],
                   fused_steps=eng.sweeps_run, launches=launched)
    check_results(label, snap, reqs, results)
    shared0 = [x.clone() for x in snap.shared]
    if ho is not None:
        ho_tokens, ho_mask = ho
        ho_reqs = [InferRequest(uid=i, tokens=ho_tokens[i, :ho_mask[i].sum()],
                                seed=2000 + i)
                   for i in range(ho_tokens.shape[0])]
        ho_res = FoldInEngine(snap, ServeConfig(**SERVE)).run(ho_reqs)
        thetas = np.stack([ho_res[r.uid].theta for r in ho_reqs])
    if tcp:
        summary["tcp"] = serve_over_tcp(snap, card)
    counts = dict(_build.LAUNCHES)
    summary["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    saved = dict(_build.LAUNCHES)
    summary["oracle_docs_bit_equal"] = check_oracle(label, snap, reqs,
                                                    results, n_check)
    summary["serve_chunk"] = serve_chunk_check(snap, reqs)
    summary["profiled_step"] = profile_step(snap, reqs)
    if ho is not None:
        ppl_fold = fold_in_perplexity(snap, thetas, ho_tokens, ho_mask)
        ppl_eval = tr.perplexity(ho_tokens, ho_mask)
        summary["perplexity"] = {"fold_in": ppl_fold, "family": ppl_eval,
                                 "ratio": ppl_fold / ppl_eval}
        if not ppl_fold <= QUALITY_TOL * ppl_eval:
            raise AssertionError(f"{label}: fold-in perplexity {ppl_fold} "
                                 f"> {QUALITY_TOL} x {ppl_eval}")
    if ckpt:
        summary["checkpoint"] = checkpoint_round_trip(tr, snap)
    if not all(torch.equal(a, b) for a, b in zip(shared0, snap.shared)):
        raise AssertionError(f"{label}: serving changed the snapshot")
    summary["snapshot_unchanged"] = True
    restore_counts(saved)
    print(f"SERVE {label} {json.dumps(summary)}", flush=True)
    print(f"SERVE {label} on {card}: {summary['docs']} docs, "
          f"{SERVE['n_sweeps']} sweeps each, {summary['fused_steps']} steps, "
          f"median step {summary['step_ms_median']:.2f} ms (host "
          f"{summary['step_host_ms_median']:.2f} ms), "
          f"{summary['docs_per_s']:.1f} docs/s in process"
          + (f"; TCP p50 {summary['tcp']['latency_p50_ms']:.1f} ms, p99 "
             f"{summary['tcp']['latency_p99_ms']:.1f} ms, "
             f"{summary['tcp']['docs_per_s']:.1f} docs/s, shed "
             f"{summary['tcp']['shed']}" if tcp else "")
          + f"; peak {summary['peak_gib']:.2f} GiB; profiled step: wall "
          f"{summary['profiled_step']['wall_ms']:.2f} ms, device busy "
          f"{summary['profiled_step']['device_busy_ms']:.2f} ms, idle share "
          f"{summary['profiled_step']['idle_share']:.3f}", flush=True)
    del snap, eng
    torch.cuda.empty_cache()
    return counts, summary


def launcher_smoke() -> dict:
    """``python -m repro_torch.launch.serve --smoke`` in a process of its
    own, its server process on ``cuda``; its output lines are printed."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke"],
        capture_output=True, text=True, env=env, timeout=LAUNCHER_TIMEOUT_S,
        cwd=str(ROOT))
    secs = time.perf_counter() - t
    for line in (out.stdout + out.stderr).strip().splitlines()[-12:]:
        print(f"  launcher| {line}")
    if out.returncode != 0:
        raise AssertionError(f"launcher smoke exited {out.returncode}")
    return {"seconds": secs, "returncode": out.returncode}


def train(label, cfg, modes, tokens, mask, ho, dev, first, kernels,
          memory_note) -> tuple[dict, float]:
    """Drive one main path: the launch counters are zeroed just before and
    read just after; every round is checked, the client-local rules (HDP's
    1 ≤ m_dk ≤ n_dk) too.  Returns the counts, the peak GiB and the last
    mode's trainer (its serving path freezes it)."""
    from repro_torch.engine import Trainer
    from repro_torch.kernels import _build

    ho_tokens, ho_mask = ho
    print(f"MEMORY {label} reckoned {memory_note}")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    for name, tcfg, rounds in modes:
        trainer = first.pop(name, None) or Trainer(
            cfg, tokens, mask, config=tcfg, seed=0, device=dev)
        before = dict(_build.LAUNCHES)
        ppl, step_s = [], 0.0
        for rnd in range(rounds):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            trainer.step()
            torch.cuda.synchronize()
            step_s += time.perf_counter() - ts
            err = trainer.consistency_error()
            viol = trainer.family.count_violations(trainer.shared)
            local_viol = sum(trainer.family.count_local_violations(loc)
                             for loc in trainer.locals_)
            ppl.append(trainer.perplexity(ho_tokens, ho_mask))
            print(f"ROUND {label}-{name} {rnd} consistency_error={err} "
                  f"violations={viol} local_violations={local_viol} "
                  f"heldout_perplexity={ppl[-1]:.3f}", flush=True)
            if err != 0.0 or viol != 0 or local_viol != 0:
                raise AssertionError(f"{label} {name} round {rnd}: "
                                     f"consistency {err}, violations {viol}, "
                                     f"local violations {local_viol}")
            if not np.isfinite(ppl[-1]):
                raise AssertionError(f"{label} {name}: perplexity {ppl[-1]}")
        if not ppl[-1] < ppl[0]:
            raise AssertionError(f"{label} {name}: perplexity did not fall: "
                                 f"{ppl}")
        launched = {n: _build.LAUNCHES[n] - before.get(n, 0)
                    for n in _build.SIGNATURES}
        want = rounds * tcfg.n_clients * cfg.sorted_chunks
        if launched[kernels["sweep"]] != want:
            raise AssertionError(f"{label} {name}: sweep launched "
                                 f"{launched[kernels['sweep']]} times, "
                                 f"expected {want}")
        if (tcfg.alias_rebuild_threshold is not None
                and launched[kernels["rows"]] < rounds):
            raise AssertionError(f"{label} {name}: {kernels['rows']} "
                                 f"launched {launched[kernels['rows']]} "
                                 f"times in {rounds} incremental rounds")
        summary = {
            "rounds": rounds, "rounds_per_s": rounds / step_s,
            "tokens_per_s": int(mask.sum()) * rounds / step_s,
            "perplexity": ppl, "launches": launched,
            "alias_builds": trainer.alias_builds}
        print(f"TRAIN {label}-{name} {json.dumps(summary)}", flush=True)
        SUMMARIES[f"{label}-{name}"] = summary
        profile_round(trainer, label, name)
        if name != modes[-1][0]:
            del trainer
            torch.cuda.empty_cache()
    counts = dict(_build.LAUNCHES)
    for kernel in kernels.values():
        if counts.get(kernel, 0) < 1:
            raise AssertionError(f"{kernel} never launched on the {label} "
                                 "main path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"MEMORY {label} peak allocated {peak:.2f} GiB")
    return counts, peak, trainer

# ---------------------------------------------------------------------------
# Phase 12: consistency policies, the top-k filter, faults and restore
# ---------------------------------------------------------------------------

def policy_rounds(label, trainer, rounds, ho, check) -> dict:
    """``rounds`` rounds of ``trainer``, each timed on the host's clock
    around ``step()`` closed by a sync, kernel 2's launches counted around
    ``step()`` alone, then ``check(r)`` and held-out perplexity."""
    from repro_torch.kernels import _build

    ms, ppl, k2 = [], [], 0
    for rnd in range(rounds):
        before = _build.LAUNCHES["alias_build"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        k2 += _build.LAUNCHES["alias_build"] - before
        note = check(rnd)
        ppl.append(trainer.perplexity(*ho))
        print(f"ROUND {label} {rnd} {ms[-1]:.2f} ms clocks="
              f"{trainer.clocks.tolist()} alias_builds={trainer.alias_builds} "
              f"{note} heldout_perplexity={ppl[-1]:.3f}", flush=True)
        if not np.isfinite(ppl[-1]):
            raise AssertionError(f"{label}: perplexity {ppl[-1]}")
    return {"round_ms": ms, "median_round_ms": statistics.median(ms),
            "mean_round_ms": sum(ms) / len(ms), "perplexity": ppl,
            "alias_build_launches": k2, "alias_builds": trainer.alias_builds,
            "clocks": trainer.clocks.tolist()}


def exact(label, trainer, rnd) -> str:
    err = trainer.consistency_error()
    viol = trainer.family.count_violations(trainer.shared)
    if err != 0.0 or viol != 0:
        raise AssertionError(f"{label} round {rnd}: consistency {err}, "
                             f"violations {viol}")
    return f"consistency_error={err} violations={viol}"


def path_counts(label, kernels=("mhw_sweep_fused", "doc_topic_lists",
                                "alias_build")) -> dict:
    from repro_torch.kernels import _build
    counts = dict(_build.LAUNCHES)
    path_counts_of(label, counts, kernels)
    return counts


def path_counts_of(label: str, counts: dict, kernels) -> None:
    """Fail unless every kernel of the path launched at least once."""
    for kernel in kernels:
        if counts.get(kernel, 0) < 1:
            raise AssertionError(f"{kernel} never launched on the {label} "
                                 "path")


def falls(label, summary) -> None:
    if not summary["perplexity"][-1] < summary["perplexity"][0]:
        raise AssertionError(f"{label}: perplexity did not fall: "
                             f"{summary['perplexity']}")


def consistency_and_faults(cfg, tokens, mask, ho, dev, snap_root: Path
                           ) -> dict:
    """Phase 12 on LDA at full width, two clients, the sorted layout: SSP
    with bound 2 and async (each exact every round), BSP with the top-k
    filter (counts conserved with the residuals), a scripted fault plan
    with snapshots (lost push, crash and rejoin, straggler), and the BSP
    restore against the uninterrupted run, bit for bit.  Returns the
    launch counts of each sub-path, each zeroed just before it."""
    import shutil

    from repro_torch.core import ps
    from repro_torch.core.fault import FaultEvent, FaultPlan
    from repro_torch.engine import Trainer, TrainerConfig
    from repro_torch.engine import round as round_mod
    from repro_torch.kernels import _build

    counts = {}
    n_tok = int(mask.sum())
    bsp_ms = 1e3 / SUMMARIES["lda-cadence"]["rounds_per_s"]
    control = {}

    def report(label, summary, peak):
        summary["peak_gib"] = peak
        summary["tokens_per_s"] = n_tok / (summary["mean_round_ms"] / 1e3)
        print(f"POLICY {label} {json.dumps(summary)}", flush=True)
        print(f"POLICY {label} mean round {summary['mean_round_ms']:.2f} ms "
              f"(median {summary['median_round_ms']:.2f}) beside phase 4's "
              f"BSP cadence {bsp_ms:.2f} ms and the BSP control's "
              f"{control.get('mean_round_ms', float('nan')):.2f} "
              f"({control.get('median_round_ms', float('nan')):.2f})",
              flush=True)

    # 12.0 BSP, cadence: the control the policies' rounds are read against,
    # timed as they are.
    tcfg = TrainerConfig(layout="sorted", n_clients=2)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    control.update(policy_rounds("bsp", tr, 6, ho,
                                 lambda r: exact("bsp", tr, r)))
    counts["bsp"] = path_counts("bsp")
    report("bsp", control, torch.cuda.max_memory_allocated() / 2**30)
    del tr
    torch.cuda.empty_cache()

    # 12.1 SSP(2), cadence: the refresh rounds are 0 and 3.
    tcfg = TrainerConfig(layout="sorted", n_clients=2, consistency="ssp:2")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    s = policy_rounds("ssp2", tr, 6, ho, lambda r: exact("ssp2", tr, r))
    counts["ssp2"] = path_counts("ssp2")
    if (s["alias_builds"], s["alias_build_launches"]) != (2, 2):
        raise AssertionError(f"ssp2: {s['alias_builds']} builds, kernel 2 "
                             f"launched {s['alias_build_launches']} times in "
                             "step(); the refreshes are rounds 0 and 3")
    if s["clocks"] != [6, 6] or tr.pstate.cache_version != 3:
        raise AssertionError(f"ssp2: clocks {s['clocks']}, cache version "
                             f"{tr.pstate.cache_version}")
    falls("ssp2", s)
    report("ssp2", s, torch.cuda.max_memory_allocated() / 2**30)
    profile_round(tr, "ssp2", "stale")          # rounds 6 (refresh), 7
    del tr
    torch.cuda.empty_cache()

    # SSP(2) with incremental rebuilds: one full build, then kernel 3 on
    # the drifted rows at the end of every round, whatever the refreshes.
    tcfg = TrainerConfig(layout="sorted", n_clients=2, consistency="ssp:2",
                         alias_rebuild_threshold=0.0,
                         alias_rebuild_rows=GATHER_ROWS,
                         alias_full_rebuild_every=16)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    s = policy_rounds("ssp2-incremental", tr, 4, ho,
                      lambda r: exact("ssp2-incremental", tr, r))
    counts["ssp2-incremental"] = path_counts(
        "ssp2-incremental", ("mhw_sweep_fused", "doc_topic_lists",
                             "alias_build", "alias_build_gather_fused"))
    k3 = counts["ssp2-incremental"]["alias_build_gather_fused"]
    if s["alias_builds"] != 1 or k3 != 4 or s["clocks"] != [4, 4]:
        raise AssertionError(f"ssp2-incremental: {s['alias_builds']} full "
                             f"builds, kernel 3 launched {k3} times, clocks "
                             f"{s['clocks']}")
    falls("ssp2-incremental", s)
    report("ssp2-incremental", s, torch.cuda.max_memory_allocated() / 2**30)
    del tr
    torch.cuda.empty_cache()

    # 12.2 async: pushes land client by client; BSP's build cadence.
    tcfg = TrainerConfig(layout="sorted", n_clients=2, consistency="async")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    s = policy_rounds("async", tr, 4, ho, lambda r: exact("async", tr, r))
    counts["async"] = path_counts("async")
    if s["clocks"] != [4, 4] or s["alias_build_launches"] != 4:
        raise AssertionError(f"async: clocks {s['clocks']}, kernel 2 "
                             f"launched {s['alias_build_launches']} times")
    falls("async", s)
    report("async", s, torch.cuda.max_memory_allocated() / 2**30)
    profile_round(tr, "async", "cadence")
    del tr
    torch.cuda.empty_cache()

    # 12.3 BSP with the top-k filter and error feedback.
    spec = ps.FilterSpec("topk", **TOPK)
    tcfg = TrainerConfig(layout="sorted", n_clients=2, filter=spec)
    sent_rows, sent, captured = [], [], {}
    real_push = round_mod.filter_push

    def kept_push(*args, **kw):
        # Keeps the round's sent deltas to count their rows after step(),
        # so that no host sync lands inside the timed round.
        out = real_push(*args, **kw)
        sent.append(out[0]["n_wk"])
        captured.setdefault("delta", args[1]["n_wk"])
        return out

    def conserved(r):
        sent_rows.extend(int((x != 0).any(1).sum()) for x in sent)
        sent.clear()
        counts_wk = sum(tr.family.count_stats(cfg, t, m, loc)["n_wk"]
                        for (t, m), loc in zip(tr.shards, tr.locals_))
        gap = counts_wk - tr.shared.n_wk - sum(res["n_wk"]
                                               for res in tr.residuals)
        err = float(gap.abs().max())
        rows = sent_rows[-tcfg.n_clients:]
        if err != 0.0 or max(rows) > TOPK["k_rows"] + TOPK["random_rows"]:
            raise AssertionError(f"topk round {r}: counts − (n_wk + Σ "
                                 f"residuals) {err}, rows sent {rows}")
        return (f"counts-(n_wk+residuals)={err} rows_sent={rows} "
                f"consistency_error={tr.consistency_error()}")

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    round_mod.filter_push = kept_push
    try:
        tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
        s = policy_rounds("topk", tr, 4, ho, conserved)
    finally:
        round_mod.filter_push = real_push
    counts["topk"] = path_counts("topk")
    falls("topk", s)
    delta = captured["delta"]
    gen = torch.Generator(device=dev).manual_seed(0)
    s["sent_rows"] = sent_rows
    s["topk_ms"] = time_ms(lambda: ps.filter_delta(delta, spec, gen), 20)
    s["topk_device_ms"] = sum_device_ms(
        lambda: ps.filter_delta(delta, spec, gen), 10)
    s["delta_rows_nonzero"] = int((delta != 0).any(1).sum())
    report("topk", s, torch.cuda.max_memory_allocated() / 2**30)
    profile_round(tr, "topk", "cadence")
    del tr, delta, captured
    torch.cuda.empty_cache()

    # 12.4 Faults under BSP with snapshots every 2 rounds.
    fault_dir = snap_root / "faults"
    shutil.rmtree(snap_root, ignore_errors=True)
    snap_root.mkdir(parents=True)
    print(f"DISK free under {snap_root}: "
          f"{shutil.disk_usage(snap_root).free / 1e9:.1f} GB", flush=True)
    plan = FaultPlan.scripted(
        FaultEvent("lost_push", client=0, start=1, stop=2),
        FaultEvent("crash", client=1, start=2, stop=4),
        FaultEvent("straggle", client=0, start=4, stop=6, period=2))
    tcfg = TrainerConfig(layout="sorted", n_clients=2, fault_plan=plan,
                         snapshot_every=2, snapshot_dir=str(fault_dir))
    flags = [plan.resolve(r, 2) for r in range(6)]
    want_clocks = np.cumsum([np.asarray(f.alive) & np.asarray(f.push_ok)
                             for f in flags], axis=0)

    def faulted(r):
        err = tr.consistency_error()
        if (err == 0.0) != (r == 0):
            raise AssertionError(f"faults round {r}: consistency {err} "
                                 "(0 only before the lost push)")
        if tr.clocks.tolist() != want_clocks[r].tolist():
            raise AssertionError(f"faults round {r}: clocks "
                                 f"{tr.clocks.tolist()}, the plan gives "
                                 f"{want_clocks[r].tolist()}")
        if tr.rejoins != (1 if r >= 4 else 0):
            raise AssertionError(f"faults round {r}: rejoins {tr.rejoins}")
        # The rejoin must have read a snapshot: its fallback (in-memory
        # locals, after a warning) gives the same numbers here, since the
        # crashed client's locals are frozen since snapshot 2.
        if read_snapshot != ([True] if r >= 4 else []):
            raise AssertionError(f"faults round {r}: rejoin snapshot reads "
                                 f"{read_snapshot} (True: one was read)")
        return f"consistency_error={err} rejoins={tr.rejoins}"

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    read_snapshot, load_latest = [], tr._load_latest_snapshot

    def load_and_note():
        snap = load_latest()
        read_snapshot.append(snap is not None)
        return snap

    tr._load_latest_snapshot = load_and_note
    s = policy_rounds("faults", tr, 6, ho, faulted)
    counts["faults"] = path_counts("faults")
    t = time.perf_counter()
    path = tr.save_snapshot()
    s["save_s"] = time.perf_counter() - t
    s["snapshot_bytes"] = os.path.getsize(path)
    report("faults", s, torch.cuda.max_memory_allocated() / 2**30)
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(fault_dir)

    # 12.5 Restore: a clean BSP run against its resumption at round 2.
    tcfg = TrainerConfig(layout="sorted", n_clients=2, snapshot_every=2,
                         snapshot_dir=str(snap_root / "restore"))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    full = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    for _ in range(4):
        full.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = Trainer.restore(cfg, tokens, mask, config=tcfg, step=2, seed=0,
                          device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    for _ in range(2):
        res.step()
    counts["restore"] = path_counts("restore")
    equal = {"n_wk": torch.equal(res.shared.n_wk, full.shared.n_wk)}
    for c, (a, b) in enumerate(zip(res.locals_, full.locals_)):
        equal[f"z{c}"] = torch.equal(a.z, b.z)
        equal[f"n_dk{c}"] = torch.equal(a.n_dk, b.n_dk)
    peak = torch.cuda.max_memory_allocated() / 2**30
    nbytes = os.path.getsize(snap_root / "restore" / "trainer-2.npz")
    print(f"RESTORE {json.dumps({'bit_equal': equal, 'restore_s': restore_s, 'snapshot_bytes': nbytes, 'save_s_faults': s['save_s'], 'peak_gib': peak, 'round_idx': res.round_idx})}",
          flush=True)
    if not all(equal.values()) or res.consistency_error() != 0.0:
        raise AssertionError(f"restore: not bit-equal to the uninterrupted "
                             f"run: {equal}")
    del full, res
    torch.cuda.empty_cache()
    shutil.rmtree(snap_root)
    return counts


# ---------------------------------------------------------------------------
# Phase 13: the wire (shard servers, the tcp Trainer, launchers)
# ---------------------------------------------------------------------------

def launched_around(counts: dict, fn):
    """Run ``fn`` and add the kernel launches it made to ``counts``."""
    from repro_torch.kernels import _build
    before = dict(_build.LAUNCHES)
    out = fn()
    for name, n in _build.LAUNCHES.items():
        if n > before.get(name, 0):
            counts[name] = counts.get(name, 0) + n - before.get(name, 0)
    return out


def meter(remote, log: dict) -> None:
    """Wrap ``remote``'s pull and push to log, per call, the wire bytes
    out and in, the frames (an RPC is a request and a reply), the host
    milliseconds, a pull's refresh flag and a push's non-zero rows."""
    for name in ("pull", "push"):
        real = getattr(remote, name)

        def call(*args, _real=real, _name=name, **kw):
            c0 = remote.counters()
            t = time.perf_counter()
            out = _real(*args, **kw)
            ms = (time.perf_counter() - t) * 1e3
            c1 = remote.counters()
            entry = {"bytes_out": c1["bytes_out"] - c0["bytes_out"],
                     "bytes_in": c1["bytes_in"] - c0["bytes_in"],
                     "frames": 2 * (c1["rpc_count"] - c0["rpc_count"]),
                     "ms": ms}
            if _name == "pull":
                entry["refreshed"] = bool(out[2])
            else:
                entry["rows"] = int(sum(
                    (v != 0).reshape(v.shape[0], -1).any(1)
                    for v in args[2].values()).count_nonzero())
            log.setdefault(_name, []).append(entry)
            return out
        setattr(remote, name, call)


def wire_servers(family: str, v: int, dev, consistency: str = "bsp"):
    from repro_torch.net.server import serve_shards
    servers = serve_shards(family, vocab_size=v, n_clients=2, n_shards=2,
                           consistency=consistency,
                           barrier_timeout=WIRE_TIMEOUT_S,
                           liveness_timeout=WIRE_TIMEOUT_S, device=dev)
    return servers, tuple("%s:%d" % s.address for s in servers)


def tcp_rounds(label, cfg, tokens, mask, dev, rounds, *, tcfg_kw=None,
               ref=None, check=None, counts=None) -> dict:
    """``rounds`` rounds of a tcp Trainer (both clients in this process)
    on two shard servers in threads of this process, each round timed on
    the host's clock around ``step()``, beside the same round of the
    in-process trainer ``ref`` when given (n_wk, or m_wk and s_wk, and
    every client's locals bit-equal after every round).  The launches of
    the tcp rounds go to ``counts``; after round r, outside the timed
    step, the statistics are pulled once (a SNAPSHOT round trip) and
    ``check(tcp, r, log, stats)`` runs (``log``: ``meter``'s entries so
    far)."""
    from repro_torch.engine import Trainer, TrainerConfig

    tcfg_kw = dict(tcfg_kw or {})
    consistency = tcfg_kw.get("consistency", "bsp")
    fam_name = type(cfg).__name__[:-len("Config")].lower()
    servers, addrs = wire_servers(fam_name, cfg.vocab_size, dev,
                                  consistency)
    log: dict = {}
    out = {"round_ms": [], "inproc_round_ms": [],
           "t0": time.perf_counter()}
    try:
        t = time.perf_counter()
        tcp = launched_around(counts, lambda: Trainer(
            cfg, tokens, mask, seed=0, device=dev, config=TrainerConfig(
                **{"layout": "sorted", "n_clients": 2, "transport": "tcp",
                   "server_addrs": addrs, **tcfg_kw})))
        out["init_s"] = time.perf_counter() - t
        meter(tcp.remote, log)
        for r in range(rounds):
            torch.cuda.synchronize()
            t = time.perf_counter()
            launched_around(counts, tcp.step)
            torch.cuda.synchronize()
            out["round_ms"].append((time.perf_counter() - t) * 1e3)
            note = ""
            stats = tcp.family.stats_dict(tcp.shared)
            if ref is not None:
                torch.cuda.synchronize()
                t = time.perf_counter()
                ref.step()
                torch.cuda.synchronize()
                out["inproc_round_ms"].append(
                    (time.perf_counter() - t) * 1e3)
                want = ref.family.stats_dict(ref.shared)
                equal = {n: torch.equal(stats[n], want[n]) for n in want}
                for c, (a, b) in enumerate(zip(tcp.locals_, ref.locals_)):
                    for f in a._fields:
                        equal[f"{f}{c}"] = torch.equal(getattr(a, f),
                                                       getattr(b, f))
                if not all(equal.values()):
                    raise AssertionError(f"{label} round {r}: not bit-equal "
                                         f"to in process: {equal}")
                note = "bit-equal to in-process"
            if check is not None:
                note += " " + check(tcp, r, log, stats)
            print(f"WIRE {label} round {r} {out['round_ms'][-1]:.1f} ms"
                  + (f" (in-process {out['inproc_round_ms'][-1]:.1f} ms)"
                     if ref is not None else "") + f" {note}", flush=True)
        out["alias_builds"] = tcp.alias_builds
        out["clocks"] = tcp.clocks.tolist()
        out["pull"], out["push"] = log.get("pull", []), log.get("push", [])
        out["counters"] = {k: x for k, x in tcp.remote.counters().items()
                           if k != "per_connection"}
        out["server_stats"] = [{k: x for k, x in st.items()
                                if k != "closed_connections"}
                               for st in tcp.remote.server_stats()]
        out["addrs"] = addrs
        out["trainer"] = tcp
        out["servers"] = servers
    except BaseException:
        for srv in servers:
            srv.close()
        raise
    return out


def close_wire(out: dict) -> None:
    out.pop("trainer").close()
    for srv in out.pop("servers"):
        srv.close()
    out.pop("addrs", None)


def wire_line(label: str, out: dict) -> None:
    def med(xs):
        return statistics.median(xs) if xs else float("nan")
    summary = {
        "round_ms": out["round_ms"], "inproc_round_ms":
        out["inproc_round_ms"],
        "median_round_ms": med(out["round_ms"]),
        "median_inproc_round_ms": med(out["inproc_round_ms"]),
        "init_s": out["init_s"],
        "pull_bytes_in": [p["bytes_in"] for p in out["pull"]],
        "pull_frames": [p["frames"] for p in out["pull"]],
        "pull_ms": [round(p["ms"], 2) for p in out["pull"]],
        "not_modified": sum(not p["refreshed"] for p in out["pull"]),
        "push_bytes_out": [p["bytes_out"] for p in out["push"]],
        "push_frames": [p["frames"] for p in out["push"]],
        "push_rows": [p["rows"] for p in out["push"]],
        "push_ms": [round(p["ms"], 2) for p in out["push"]],
        "alias_builds": out["alias_builds"], "clocks": out["clocks"],
        "counters": out["counters"], "server_stats": out["server_stats"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "seconds": time.perf_counter() - out["t0"]}
    for key in ("launches", "from_servers_s", "breakdown", "checksums"):
        if key in out:
            summary[key] = out[key]
    if summary["inproc_round_ms"]:
        summary["idle_share_derived"] = max(
            0.0, 1 - summary["median_inproc_round_ms"]
            / summary["median_round_ms"])
    print(f"WIRE {label} {json.dumps(summary)}", flush=True)
    WIRE[label] = summary


def pull_breakdown(out: dict, dev) -> dict:
    """One shard's pull, its stages timed apart: the store's copy to the
    host, the frame's encoding (npz) and decoding, the copy back to the
    card; and a push's content digest (sha256) on the same arrays."""
    from repro_torch.net import protocol
    from repro_torch.net.server import mutation_digest

    srv = out["servers"][0]
    times = {}
    with srv._cond:
        t = time.perf_counter()
        arrays = srv._state_arrays_locked()
        times["d2h_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    payload = protocol.pack_payload({"version": 0}, arrays)
    times["pack_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    _, back = protocol.unpack_payload(payload)
    times["unpack_ms"] = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    for v in back.values():
        torch.from_numpy(v).to(dev)
    torch.cuda.synchronize()
    times["h2d_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    mutation_digest(arrays)
    times["digest_ms"] = (time.perf_counter() - t) * 1e3
    times["payload_bytes"] = len(payload)
    return times


def start_failover(root: Path, dev) -> dict:
    """``launch_failover`` (phase 13's (f)) in a thread of this process:
    ``{"thread", "res", "seconds"}`` or ``"error"`` once it is joined."""
    import threading

    from repro_torch.launch import loopback

    box: dict = {}

    def run():
        t = time.perf_counter()
        try:
            box["res"] = loopback.launch_failover(
                client_sets=((0,), (1,)), n_rounds=6, kill_server_round=3,
                kill_client=1, kill_client_round=2, layout="sorted",
                chaos_plan=loopback.failover_plan(),
                timeout=LOOPBACK_TIMEOUT_S, workdir=str(root / "failover"),
                device=dev.type, **FAILOVER)
        except BaseException as e:      # re-raised by the caller
            box["error"] = e
        box["seconds"] = time.perf_counter() - t

    box["thread"] = threading.Thread(target=run)
    box["thread"].start()
    return box


def wire(cfg, pcfg, ccfg, tokens, mask, dev, root: Path) -> dict:
    """Phase 13 (see the module docstring); returns the launch counts of
    each path, each zeroed just before it."""
    import shutil

    from repro_torch.core import ps
    from repro_torch.engine import Trainer, TrainerConfig
    from repro_torch.launch import loopback
    from repro_torch.net.client import _checksum
    from repro_torch.serve import snapshot as snap_mod

    counts: dict[str, dict] = {}
    bsp = TrainerConfig(layout="sorted", n_clients=2)
    lm_kernels_ = ("mhw_sweep_fused", "doc_topic_lists", "alias_build")

    def checksums(stats):
        return {n: _checksum(x) for n, x in stats.items()}

    def exact_check(last: int):
        """Counts from the assignments against the round's statistics
        (``consistency_error``'s arithmetic on the statistics already
        pulled) == 0.0 and no violation of the shared rules; after round
        ``last`` also ``consistency_error()`` itself (its own SNAPSHOT)."""
        def check(tr, r, log, stats):
            fam, totals = tr.family, {}
            for (t_, m_), loc in zip(tr.shards, tr.locals_):
                for n, x in fam.count_stats(tr.cfg, t_, m_, loc).items():
                    totals[n] = x if n not in totals else totals[n] + x
            err = max(float((totals[n] - stats[n]).abs().max())
                      for n in fam.conserved_stats)
            viol = fam.count_violations(fam.shared_from_dict(stats))
            if r == last:
                err = max(err, tr.consistency_error())
            if err != 0.0 or viol != 0:
                raise AssertionError(f"wire round {r}: consistency {err}, "
                                     f"violations {viol}")
            return f"consistency_error={err} violations={viol}"
        return check

    def bsp_check(tr, r, log, stats):
        per_round.append(checksums(stats))
        return exact_check(1)(tr, r, log, stats)

    # (a) tcp-bsp: bit-equal to an in-process BSP trainer every round.
    t_path = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ref = Trainer(cfg, tokens, mask, config=bsp, seed=0, device=dev)
    per_round: list[dict] = []
    counts["tcp-bsp"] = {}
    out = tcp_rounds("tcp-bsp", cfg, tokens, mask, dev, 1, ref=ref,
                     check=bsp_check, counts=counts["tcp-bsp"])
    path_counts_of("tcp-bsp", counts["tcp-bsp"], lm_kernels_)
    out["launches"] = counts["tcp-bsp"]
    out["breakdown"] = pull_breakdown(out, dev)
    path_seconds("13", "tcp-bsp", t_path)
    counts["tcp-from-servers"] = {}
    t = time.perf_counter()
    frozen = launched_around(counts["tcp-from-servers"], lambda:
                             snap_mod.from_servers(out["addrs"], cfg,
                                                   n_clients=2, min_round=1,
                                                   device=dev))
    torch.cuda.synchronize()
    out["from_servers_s"] = time.perf_counter() - t
    path_counts_of("tcp-from-servers", counts["tcp-from-servers"],
                   ("alias_build",))
    want = snap_mod.freeze(cfg, ref.shared, dev)
    same = [torch.equal(a, b) for a, b in zip(
        (*frozen.shared, *frozen.tables, frozen.stale),
        (*want.shared, *want.tables, want.stale))]
    if not all(same):
        raise AssertionError(f"from_servers != freeze of the in-process "
                             f"statistics: {same}")
    del frozen, want
    out["checksums"] = per_round[0]
    close_wire(out)
    wire_line("tcp-bsp", out)
    path_seconds("13", "from-servers", t)

    # (a') sparse_push without a filter, one round: bit-equal to (a)'s.
    def as_dense(tr, r, log, stats):
        if checksums(stats) != per_round[r]:
            raise AssertionError(f"tcp-sparse round {r}: checksums differ "
                                 "from tcp-bsp's")
        return "checksums equal to tcp-bsp's"

    t = time.perf_counter()
    counts["tcp-sparse"] = {}
    out = tcp_rounds("tcp-sparse", cfg, tokens, mask, dev, 1,
                     tcfg_kw={"sparse_push": True},
                     counts=counts["tcp-sparse"], check=as_dense)
    path_counts_of("tcp-sparse", counts["tcp-sparse"], lm_kernels_)
    close_wire(out)
    wire_line("tcp-sparse", out)
    del ref
    torch.cuda.empty_cache()
    path_seconds("13", "tcp-sparse", t)

    # (b) tcp-topk: the top-k filter's error feedback conserves counts;
    # sparse frames carry at most k_rows + random_rows rows.
    spec = ps.FilterSpec("topk", **TOPK)

    def conserved(tr, r, log, stats):
        counts_wk = sum(tr.family.count_stats(cfg, t_, m_, loc)["n_wk"]
                        for (t_, m_), loc in zip(tr.shards, tr.locals_))
        gap = counts_wk - stats["n_wk"] - sum(res["n_wk"]
                                              for res in tr.residuals)
        err = float(gap.abs().max())
        rows = [p["rows"] for p in log["push"][-2:]]
        if err != 0.0 or max(rows) > TOPK["k_rows"] + TOPK["random_rows"]:
            raise AssertionError(f"tcp-topk round {r}: counts − (n_wk + Σ "
                                 f"residuals) {err}, rows a push {rows}")
        return f"counts-(n_wk+residuals)={err} rows_sent={rows}"

    t = time.perf_counter()
    counts["tcp-topk"] = {}
    torch.cuda.reset_peak_memory_stats()
    out = tcp_rounds("tcp-topk", cfg, tokens, mask, dev, 1,
                     tcfg_kw={"filter": spec, "sparse_push": True},
                     counts=counts["tcp-topk"], check=conserved)
    path_counts_of("tcp-topk", counts["tcp-topk"], lm_kernels_)
    close_wire(out)
    wire_line("tcp-topk", out)
    torch.cuda.empty_cache()
    path_seconds("13", "tcp-topk", t)

    # (c) tcp-ssp2: exact every round; NOT_MODIFIED on the stale round;
    # kernel 2 on the refresh (round 0) only.
    t = time.perf_counter()
    counts["tcp-ssp2"] = {}
    torch.cuda.reset_peak_memory_stats()
    out = tcp_rounds("tcp-ssp2", cfg, tokens, mask, dev, 2,
                     tcfg_kw={"consistency": "ssp:2"},
                     counts=counts["tcp-ssp2"], check=exact_check(1))
    path_counts_of("tcp-ssp2", counts["tcp-ssp2"], lm_kernels_)
    refreshed = [p["refreshed"] for p in out["pull"]]
    k2 = counts["tcp-ssp2"].get("alias_build", 0)
    if refreshed != [True, False] \
            or out["alias_builds"] != 1 or k2 != 1:
        raise AssertionError(f"tcp-ssp2: pulls refreshed {refreshed}, alias "
                             f"builds {out['alias_builds']}, kernel 2 "
                             f"launched {k2}")
    close_wire(out)
    wire_line("tcp-ssp2", out)
    torch.cuda.empty_cache()
    path_seconds("13", "tcp-ssp2", t)

    # (d) tcp-pdp: PDP over two shards (a one-shard pull of m_wk and s_wk
    # would pass MAX_PAYLOAD), bit-equal to in process.
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pref = Trainer(pcfg, tokens, mask, config=bsp, seed=0, device=dev)
    counts["tcp-pdp"] = {}
    out = tcp_rounds("tcp-pdp", pcfg, tokens, mask, dev, 1, ref=pref,
                     counts=counts["tcp-pdp"])
    path_counts_of("tcp-pdp", counts["tcp-pdp"],
                   ("pdp_sweep_fused", "doc_topic_lists", "alias_build"))
    close_wire(out)
    wire_line("tcp-pdp", out)
    del pref
    torch.cuda.empty_cache()
    path_seconds("13", "tcp-pdp", t)

    # (e) loopback: a shard process (two shards) and two worker
    # processes, all on the card; checksums equal to each other's and to
    # tcp-bsp's after 1 round; each worker reports its own launches.
    shutil.rmtree(root, ignore_errors=True)
    for sub in ("loopback", "failover"):
        (root / sub).mkdir(parents=True)
    # (f) runs beside (e): their processes, ports and directories are
    # their own.
    t_pair = time.perf_counter()
    failover = start_failover(root, dev)
    t = time.perf_counter()
    res = loopback.launch_loopback(
        family="lda", vocab_size=cfg.vocab_size, n_topics=cfg.n_topics,
        n_shards=2, client_sets=((0,), (1,)), n_rounds=1,
        n_docs=ccfg.n_docs, doc_len=ccfg.doc_len, corpus_seed=ccfg.seed,
        seed=0, layout="sorted", timeout=LOOPBACK_TIMEOUT_S,
        workdir=str(root / "loopback"),
        extra_client_args=("--corpus-topics", str(ccfg.n_topics),
                           "--eval-docs", "32"), device=dev.type)
    secs = path_seconds("13", "loopback (beside failover)", t)
    if not res.ok:
        for p in res.failures():
            print(f"  loopback| {p.name} exit {p.returncode}: "
                  f"{loopback._tail(p.stderr)}", flush=True)
        raise AssertionError(f"loopback: {res.diagnostics}")
    sums = [p.result["checksums"] for p in res.clients]
    summary = {"seconds": secs, "checksums_agree": sums[0] == sums[1],
               "equal_to_tcp_bsp": sums[0] == WIRE["tcp-bsp"]["checksums"],
               "beside": "(f)'s failover launcher and its processes: the "
                         "seconds and rounds_per_s are not the card's alone",
               "workers": [{k: p.result[k] for k in (
                   "clients", "rounds_per_s", "launches", "device",
                   "perplexity")} for p in res.clients]}
    print(f"WIRE loopback {json.dumps(summary)}", flush=True)
    if not (summary["checksums_agree"] and summary["equal_to_tcp_bsp"]):
        raise AssertionError(f"loopback: worker checksums {sums}, tcp-bsp "
                             f"{WIRE['tcp-bsp']['checksums']}")
    for i, p in enumerate(res.clients):
        counts[f"loopback-worker{i}"] = dict(p.result["launches"])
        path_counts_of(f"loopback-worker{i}", p.result["launches"],
                       lm_kernels_)
    WIRE["loopback"] = summary

    # (f) failover at a reduced size (K=64, V=8192): the time and disk of
    # the restarts; bit-equal to an undisturbed in-process run.
    failover["thread"].join()
    path_seconds("13", "loopback and failover, wall", t_pair)
    if "error" in failover:
        raise failover["error"]
    res, secs = failover["res"], failover["seconds"]
    PATHS["13"]["failover (beside loopback)"] = round(secs, 1)
    if not res.ok:
        for p in res.failures():
            print(f"  failover| {p.name} exit {p.returncode}: "
                  f"{loopback._tail(p.stderr)}", flush=True)
        raise AssertionError(f"failover: {res.diagnostics}")
    finals = [p.result for p in res.clients if p.returncode == 0
              and p.result]
    t = time.perf_counter()
    want = loopback._reference_run(6, layout="sorted", device=dev.type,
                                   **FAILOVER)
    path_seconds("13", "failover's in-process reference", t)
    drops = sum(p["actions"]["conn_drop"] for p in res.proxies)
    summary = {"reduced": f"K={FAILOVER['n_topics']}, "
               f"V={FAILOVER['vocab_size']}, {FAILOVER['n_docs']} documents "
               f"of {FAILOVER['doc_len']} (the restarts' time and disk)",
               "seconds": secs, "beside": "(e)'s loopback launcher",
               "restarts": res.restarts, "drops": drops,
               "bit_equal": all(r["checksums"] == want["checksums"]
                                for r in finals),
               "workers": [{k: r[k] for k in ("clients", "restored",
                                              "rounds_done", "launches")}
                           for r in finals]}
    print(f"WIRE failover {json.dumps(summary)}", flush=True)
    if res.restarts != {"server": 1, "client": 1} or drops != 1 \
            or len(finals) != 2 or not summary["bit_equal"]:
        raise AssertionError(f"failover: {summary}")
    for r in finals:
        counts[f"failover-worker{r['clients'][0]}"] = dict(r["launches"])
    WIRE["failover"] = summary
    shutil.rmtree(root)
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the position-scan layout at full width
# ---------------------------------------------------------------------------

class KernelTap:
    """Pass ``ops.sample_rows`` and ``ops.mh_accept`` through, keeping the
    inputs of their first call (the scan chain's first position and MH
    step) for the kernel checks; the tables by reference, the rest
    copied (the chain writes its state views over).  Likewise
    ``ops.mhw_sweep_sorted`` and ``ops.pdp_sweep_sorted`` (the first sorted
    chunk), kept as kernel 1's or 4's arguments and keywords, the step
    uniforms drawn here as the wrapper would draw them."""

    def __init__(self):
        self.inputs: dict[str, tuple] = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.real = (ops.sample_rows, ops.mh_accept, ops.mhw_sweep_sorted,
                     ops.pdp_sweep_sorted)
        real8, real9, real1, real4 = self.real

        def uniforms_of(generator, tables, rows, stats, mh_steps, uniforms):
            if uniforms is not None:
                return uniforms
            return ops._step_uniforms(generator, tables.prob.shape[-1],
                                      mh_steps, rows.shape[0], stats.device)

        def mhw_sweep_sorted(tables, stale, n_wk, n_k, prior, rows, docs,
                             z0, n_dk, generator, *, mh_steps, beta,
                             beta_bar, uniforms=None, device=None):
            uniforms = uniforms_of(generator, tables, rows, n_wk, mh_steps,
                                   uniforms)
            if "mhw_sweep_fused" not in self.inputs:
                self.inputs["mhw_sweep_fused"] = (
                    (tables.prob, tables.alias, tables.mass, stale,
                     *(t.clone() for t in (n_wk, n_k)), prior,
                     *(t.clone() for t in (rows, docs, z0, n_dk)),
                     *uniforms), {"beta": beta, "beta_bar": beta_bar})
            return real1(tables, stale, n_wk, n_k, prior, rows, docs, z0,
                         n_dk, generator, mh_steps=mh_steps, beta=beta,
                         beta_bar=beta_bar, uniforms=uniforms, device=device)

        def pdp_sweep_sorted(tables, stale, m_wk, s_wk, m_k, s_k, stirl,
                             prior, rows, docs, e0, n_dk, generator, *,
                             mh_steps, concentration, discount, gamma,
                             gamma_bar, uniforms=None, device=None):
            uniforms = uniforms_of(generator, tables, rows, m_wk, mh_steps,
                                   uniforms)
            if "pdp_sweep_fused" not in self.inputs:
                self.inputs["pdp_sweep_fused"] = (
                    (tables.prob, tables.alias, tables.mass, stale,
                     *(t.clone() for t in (m_wk, s_wk, m_k, s_k)), stirl,
                     prior, *(t.clone() for t in (rows, docs, e0, n_dk)),
                     *uniforms),
                    {"b": concentration, "a": discount, "gamma": gamma,
                     "gamma_bar": gamma_bar})
            return real4(tables, stale, m_wk, s_wk, m_k, s_k, stirl, prior,
                         rows, docs, e0, n_dk, generator, mh_steps=mh_steps,
                         concentration=concentration, discount=discount,
                         gamma=gamma, gamma_bar=gamma_bar, uniforms=uniforms,
                         device=device)

        def sample_rows(tables, rows, generator=None, *, uniforms=None,
                        device=None):
            if "alias_sample" not in self.inputs:
                self.inputs["alias_sample"] = (
                    tables, rows.clone(), uniforms[0].clone(),
                    uniforms[1].clone())
            return real8(tables, rows, generator, uniforms=uniforms,
                         device=device)

        def mh_accept(z, cand, lp_z, lp_c, lq_z, lq_c, generator=None, *,
                      u=None, device=None):
            if "mh_accept" not in self.inputs:
                self.inputs["mh_accept"] = tuple(
                    t.clone() for t in (z, cand, lp_z, lp_c, lq_z, lq_c, u))
            return real9(z, cand, lp_z, lp_c, lq_z, lq_c, generator, u=u,
                         device=device)

        (ops.sample_rows, ops.mh_accept, ops.mhw_sweep_sorted,
         ops.pdp_sweep_sorted) = (sample_rows, mh_accept, mhw_sweep_sorted,
                                  pdp_sweep_sorted)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        (ops.sample_rows, ops.mh_accept, ops.mhw_sweep_sorted,
         ops.pdp_sweep_sorted) = self.real
        return False


def acceptance_rate(tr, cfg, dev) -> float:
    """``mh_chain_with_stats``'s acceptance rate on client 0's first
    position, as ``bench_throughput`` measures it: the sparse term
    n_dk·φ_w with the fresh language model, the dense term from the
    trainer's current alias tables, log p = log((n_dk + α)·φ_w + 1e-30),
    ``mh_steps`` steps from the current topics; its launches are not the
    path's."""
    from repro_torch.core import lda, mhw
    from repro_torch.kernels import _build

    saved = dict(_build.LAUNCHES)
    t, _ = tr.shards[0]
    loc = tr.locals_[0]
    w = t[:, 0].to(torch.int32).contiguous()
    wl = w.long()
    lm = lda.language_model(cfg, tr.shared)
    docs = torch.arange(w.shape[0], device=dev)
    prop = mhw.MixtureProposal(loc.n_dk * lm[wl], tr.pstate.tables, w)

    def log_p(z):
        zl = z.long()
        return torch.log((loc.n_dk[docs, zl] + cfg.alpha) * lm[wl, zl]
                         + 1e-30)

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    _, rate = mhw.mh_chain_with_stats(gen, loc.z[:, 0], prop,
                                      tr.pstate.stale, log_p, cfg.mh_steps)
    rate = float(rate)
    restore_counts(saved)
    return rate


def scan_path(label, cfg, tcfg, rounds, tokens, mask, ho, dev, kernels,
              sorted_ppl=None, tap=None, accept=False):
    """Drive one scan path: a fresh Trainer, ``rounds`` rounds each timed on
    the host's clock around ``step()`` closed by a sync, checked (exact,
    no violation, HDP's local rules) and evaluated on ``ho``; the launch
    counters zeroed just before and read just after.  Every kernel of
    ``kernels`` must have launched, and kernels 8 and 9 exactly clients ×
    positions × mh_steps times a round under MHW (0 under exact).  With
    ``tap`` the last round runs under it; with ``accept`` the acceptance
    rate is taken after the first and the last round.  Returns (trainer,
    counts, summary)."""
    from repro_torch.engine import Trainer
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    ms, ppl, rates = [], [], []
    for rnd in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if tap is not None and rnd == rounds - 1:
            with tap:
                tr.step()
        else:
            tr.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        err = tr.consistency_error()
        viol = tr.family.count_violations(tr.shared)
        local_viol = sum(tr.family.count_local_violations(loc)
                         for loc in tr.locals_)
        if err != 0.0 or viol != 0 or local_viol != 0:
            raise AssertionError(f"{label} round {rnd}: consistency {err}, "
                                 f"violations {viol}, local violations "
                                 f"{local_viol}")
        ppl.append(tr.perplexity(*ho))
        if not np.isfinite(ppl[-1]):
            raise AssertionError(f"{label}: perplexity {ppl[-1]}")
        if accept and rnd in (0, rounds - 1):
            rates.append(acceptance_rate(tr, cfg, dev))
        beside = ""
        if sorted_ppl and rnd < len(sorted_ppl) \
                and sorted_ppl[rnd] is not None:
            beside = f" (phase 4-8's sorted at round {rnd}: " \
                     f"{sorted_ppl[rnd]:.3f})"
        print(f"SCAN {label} round {rnd} {ms[-1]:.1f} ms consistency_error="
              f"{err} violations={viol} local_violations={local_viol} "
              f"heldout_perplexity={ppl[-1]:.3f}{beside}", flush=True)
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rounds > 1 and not ppl[-1] < ppl[0]:
        raise AssertionError(f"{label}: perplexity did not fall: {ppl}")
    path_counts_of(label, counts, kernels)
    l = tokens.shape[1]
    want = (rounds * tcfg.n_clients * l * cfg.mh_steps
            if tcfg.method == "mhw" else 0)
    for name in ("alias_sample", "mh_accept"):
        if counts.get(name, 0) != want:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{counts.get(name, 0)} times, predicted "
                                 f"{want} ({rounds} rounds × "
                                 f"{tcfg.n_clients} clients × {l} "
                                 "positions × mh_steps)")
    mean_s = sum(ms) / len(ms) / 1e3
    summary = {"rounds": rounds, "round_ms": ms,
               "median_round_ms": statistics.median(ms),
               "tokens_per_s": int(mask.sum()) / mean_s, "peak_gib": peak,
               "perplexity": ppl, "sorted_perplexity": (
                   list(sorted_ppl[:rounds]) if sorted_ppl else None),
               "launches": counts, "k8_k9_predicted": want,
               "alias_builds": tr.alias_builds}
    if accept:
        summary["acceptance_first_last"] = rates
    print(f"SCAN {label} {json.dumps(summary)}", flush=True)
    return tr, counts, summary


def scan_kernel_figures(label, inputs, e_out: int) -> dict:
    """Kernels 8 and 9 on one real scan position's inputs (``KernelTap``),
    against their plain versions on the same card tensors, timed as a
    call, on the device's clock and as the plain version; bounds from
    this input's bytes (kernel 8: rows, slot, coin and the draw for each
    entry, prob at each distinct (row, slot) entry and alias where the
    coin took it; kernel 9: seven 4-byte inputs and the state)."""
    from repro_torch.kernels import alias_sample as kas
    from repro_torch.kernels import mh_accept as kma
    from repro_torch.kernels import ref

    tables, rows, slot, coin = inputs["alias_sample"]
    b = rows.shape[0]
    got8 = kas.alias_sample(tables.prob, tables.alias, rows, slot, coin)
    want8 = ref.alias_sample_ref(tables.prob, tables.alias, rows, slot, coin)
    if not torch.equal(got8, want8):
        raise AssertionError(f"{label}: kernel 8 differs from plain in "
                             f"{int((got8 != want8).sum())} of {b} draws")
    key = rows.long() * e_out + slot.long()
    took = ~(coin < tables.prob.view(-1)[key])
    bytes8 = (b * 16 + int(torch.unique(key).numel()) * 4
              + int(torch.unique(key[took]).numel()) * 4)
    args9 = inputs["mh_accept"]
    z, cand, lp_z, lp_c, lq_z, lq_c, u = args9
    got9 = kma.mh_accept(*args9)
    want9 = ref.mh_accept_ref(*args9)
    differ = got9 != want9
    if bool(differ.any()):
        ratio = ((lp_c - lp_z) + lq_z) - lq_c
        near = (torch.log(u + 1e-30) - ratio).abs() <= \
            2 * torch.finfo(torch.float32).eps * ratio.abs().clamp_min(1.0)
        if not bool(near[differ].all()):
            raise AssertionError(f"{label}: kernel 9 differs from plain "
                                 "away from an accept tie")
    out = {}
    for name, fn, plain, nbytes, symbol in (
            ("alias_sample", lambda: kas.alias_sample(
                tables.prob, tables.alias, rows, slot, coin),
             lambda: ref.alias_sample_ref(tables.prob, tables.alias, rows,
                                          slot, coin),
             bytes8, "alias_sample_batch_kernel"),
            ("mh_accept", lambda: kma.mh_accept(*args9),
             lambda: ref.mh_accept_ref(*args9), b * 32, "mh_accept_kernel")):
        bound_ms, bound_by = bound(nbytes, 0)
        out[name] = {"B": b, "E": e_out, "ms": time_ms(fn, 50),
                     "device_ms": device_ms(fn, 50, symbol),
                     "plain_ms": time_ms(plain, 20), "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes,
                     "bit_equal": bool(torch.equal(
                         got8 if name == "alias_sample" else got9,
                         want8 if name == "alias_sample" else want9)),
                     "states_differing": (0 if name == "alias_sample"
                                          else int(differ.sum()))}
        if name == "mh_accept":
            out[name]["accepted_share"] = float((got9 == cand).float().mean())
        print(f"SCAN-KERNEL {label} {name} {json.dumps(out[name])}",
              flush=True)
    return out


def scan_cpu_card(dev) -> dict:
    """One scan sweep at K=16 (64 documents of 32 tokens, V=256) on the CPU
    and on the card from the same state, tables and injected draws (LDA
    MHW and exact, PDP MHW): the share of z (and PDP's r) and of the delta
    entries that differ.  Not a path: its launches are left out."""
    from repro_torch.core import family, mhw
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.kernels import _build

    saved = dict(_build.LAUNCHES)
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=8, vocab_size=256, n_docs=64, doc_len=32, seed=3))
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    d, l = tt.shape
    out = {}

    def to(tree, where):
        if isinstance(tree, torch.Tensor):
            return tree.to(where)
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(to(x, where) for x in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(to(x, where) for x in tree)
        return tree

    for name, method in (("lda", "mhw"), ("lda", "exact"), ("pdp", "mhw")):
        fam = family.get(name)
        cfg = fam.config_cls(n_topics=16, vocab_size=256)
        loc, sh = fam.init_state(cfg, tt, tm, (0, 0))
        tables, stale = fam.build_alias(cfg, sh)
        e = fam.n_outcomes(cfg)
        gen = torch.Generator()
        gen.manual_seed(5)
        draws = [[mhw.draw_step(gen, d, e, "cpu")
                  for _ in range(cfg.mh_steps)] if method == "mhw"
                 else mhw.gumbel(gen, (d, e), "cpu") for _ in range(l)]
        cpu_loc, cpu_d = fam.sweep(cfg, loc, sh, tables, stale, tt, tm, (0,),
                                   method=method, device="cpu",
                                   position_draws=lambda i: draws[i])
        card_draws = to(draws, dev)
        card_loc, card_d = fam.sweep(
            cfg, to(loc, dev), to(sh, dev), to(tables, dev), stale.to(dev),
            tt.to(dev), tm.to(dev), (0,), method=method, device=dev,
            position_draws=lambda i: card_draws[i])
        diff = {f: float((getattr(card_loc, f).cpu()
                          != getattr(cpu_loc, f)).float().mean())
                for f in ("z", "r") if f in fam.local_stats}
        diff.update({n: float((card_d[n].cpu() != cpu_d[n]).float().mean())
                     for n in fam.delta_names})
        out[f"{name}-{method}"] = diff
        print(f"SCAN cpu-card {name}-{method} K=16 shares differing "
              f"{json.dumps(diff)}", flush=True)
        if diff["z"] > SWEEP_MISMATCH_TOL:
            raise AssertionError(f"scan cpu-card {name}-{method}: z differs "
                                 f"in {diff['z']} of positions")
    restore_counts(saved)
    return out


def scan(cfg, pcfg, hcfg, tokens, mask, ho, ho_hdp, dev,
         wire_corpus) -> tuple:
    """Phase 14 (see the module docstring; tcp-scan on ``wire_corpus``,
    phase 13's documents); returns (the launch counts of each path, each
    zeroed just before it; kernels 8 and 9 at the scan grid, for the
    kernels JSON)."""
    from repro_torch.engine import Trainer, TrainerConfig
    from repro_torch.kernels import _build

    counts, figures, summaries = {}, {}, {}
    scan_mhw = TrainerConfig(layout="scan", method="mhw", n_clients=2)
    k289 = ("alias_build", "alias_sample", "mh_accept")
    sorted_ppl = {f: SUMMARIES.get(f"{f}-cadence", {}).get("perplexity")
                  for f in ("lda", "pdp", "hdp")}

    t = time.perf_counter()
    tap = KernelTap()
    tr, counts["scan-lda"], summaries["scan-lda"] = scan_path(
        "scan-lda", cfg, scan_mhw, 2, tokens, mask, ho, dev, k289,
        sorted_ppl["lda"], tap=tap, accept=True)
    figures["lda"] = scan_kernel_figures("scan-lda", tap.inputs,
                                         cfg.n_topics)
    path_seconds("14", "scan-lda", t)
    t = time.perf_counter()
    profile_round(tr, "scan-lda", "cadence", opening_round=False)
    del tr, tap
    torch.cuda.empty_cache()
    path_seconds("14", "scan-lda profiled round", t)

    t = time.perf_counter()
    inc = TrainerConfig(layout="scan", method="mhw", n_clients=2,
                        alias_rebuild_threshold=0.0,
                        alias_rebuild_rows=GATHER_ROWS,
                        alias_full_rebuild_every=16)
    tr, counts["scan-lda-incremental"], summaries[
        "scan-lda-incremental"] = scan_path(
        "scan-lda-incremental", cfg, inc, 2, tokens, mask, ho, dev,
        ("alias_build_gather_fused", "alias_sample", "mh_accept"))
    del tr
    torch.cuda.empty_cache()
    path_seconds("14", "scan-lda-incremental", t)

    t = time.perf_counter()
    exact_cfg = TrainerConfig(layout="scan", method="exact", n_clients=2)
    tr, counts["scan-lda-exact"], summaries["scan-lda-exact"] = scan_path(
        "scan-lda-exact", cfg, exact_cfg, 2, tokens, mask, ho, dev,
        ("alias_build",))
    del tr
    torch.cuda.empty_cache()
    path_seconds("14", "scan-lda-exact", t)

    # Phase 8's cadence mode began after phase 7's round: its round r is
    # the sorted trainer's round r + 1.  Four rounds: over the first two
    # HDP's held-out perplexity rises (by 0.2% on an H100 at this size)
    # while θ0 first concentrates, and falls from the third.
    t = time.perf_counter()
    tr, counts["scan-hdp"], summaries["scan-hdp"] = scan_path(
        "scan-hdp", hcfg, scan_mhw, 4, tokens, mask, ho_hdp, dev, k289,
        [None] + list(sorted_ppl["hdp"] or []))
    del tr
    torch.cuda.empty_cache()
    path_seconds("14", "scan-hdp", t)

    t = time.perf_counter()
    tap = KernelTap()
    tr, counts["scan-pdp"], summaries["scan-pdp"] = scan_path(
        "scan-pdp", pcfg, scan_mhw, 2, tokens, mask, ho, dev, k289,
        sorted_ppl["pdp"], tap=tap)
    figures["pdp"] = scan_kernel_figures("scan-pdp", tap.inputs,
                                         2 * pcfg.n_topics)
    del tr, tap
    torch.cuda.empty_cache()
    path_seconds("14", "scan-pdp", t)

    # tcp-scan: one LDA round over two shard servers in threads of this
    # process, bit-equal to the same round in process.
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ref = Trainer(cfg, *wire_corpus, config=scan_mhw, seed=0, device=dev)
    counts["tcp-scan"] = {}
    out = tcp_rounds("tcp-scan", cfg, *wire_corpus, dev, 1,
                     tcfg_kw={"layout": "scan"}, ref=ref,
                     counts=counts["tcp-scan"],
                     check=lambda tr_, r, log, stats: exact("tcp-scan", tr_,
                                                            r))
    path_counts_of("tcp-scan", counts["tcp-scan"], k289)
    want = 2 * tokens.shape[1] * cfg.mh_steps
    if counts["tcp-scan"].get("alias_sample") != want:
        raise AssertionError(f"tcp-scan: kernel 8 launched "
                             f"{counts['tcp-scan'].get('alias_sample')} "
                             f"times, predicted {want}")
    out["launches"] = counts["tcp-scan"]
    close_wire(out)
    wire_line("tcp-scan", out)
    del ref
    torch.cuda.empty_cache()
    path_seconds("14", "tcp-scan", t)

    t = time.perf_counter()
    figures["cpu_card"] = scan_cpu_card(dev)
    path_seconds("14", "cpu-card", t)
    _build.reset_launches()
    return counts, figures


# ---------------------------------------------------------------------------
# Phase 15: the mesh round (core.distributed.make_round_fn)
# ---------------------------------------------------------------------------

# 15b's ranks run ~40 s; a hung one fails the smoke well inside its limit.
MESH_TIMEOUT_S = 300.0
# Phase 15b's runs on the 2x2 gloo mesh: (path, server shards, each
# round's live flags); the last round of the first run is profiled on
# rank 0.
MESH_PLAN = (("mesh-2x2-alg2", 1, ([True, True],) * 2),
             ("mesh-2x2-alg1", 2, ([True, True], [True, False])))
MESH_SYNC_KEY = 9


def sha(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes, read on the host."""
    import hashlib
    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def mesh_init(fam, cfg, shards):
    """Every client's initial locals, client c from the stream (0, INIT,
    c), and the statistics summed in client order."""
    from repro_torch import device as device_mod
    locals_, shared = [], None
    for c, (t, m) in enumerate(shards):
        loc, sh = fam.init_state(cfg, t, m, (0, device_mod.INIT, c))
        locals_.append(loc)
        shared = sh if shared is None else fam.shared_from_dict({
            n: v + fam.stats_dict(sh)[n]
            for n, v in fam.stats_dict(shared).items()})
        del sh
    return locals_, shared


def composed_round(fam, server, cfg, dcfg, locals_, state, shards, layouts,
                   key, alive, dev):
    """The mesh round of ``len(locals_)`` clients composed in one process
    without torch.distributed, as its definition reads: the policy's pull,
    each client's ``client_round`` from ``fold_in(key, c)``, the filter,
    the push as a sum in client order, ``apply_delta``, Algorithm 1 and
    the server's bookkeeping.  Returns (locals', state')."""
    from repro_torch import device as device_mod
    from repro_torch.core import distributed, projection

    pol = server.policy
    clock_now = int(state.clocks.max())
    refresh = not pol.caches or clock_now - state.cache_version > pol.bound
    snapshot, cache, version = server.pull_round(state, clock_now, refresh)
    lag = server.reset_lag(state.client_lag, refresh)
    canonical = server.assemble(state) if pol.caches else snapshot
    out, total, rows = [], None, []
    for c, (local, (t, m)) in enumerate(zip(locals_, shards)):
        key_c = device_mod.fold_in(key, c)
        loc, deltas = distributed.client_round(
            cfg, fam, dcfg, local, server.client_view(snapshot, lag, c),
            state.tables, state.stale, t, m, key_c,
            sorted_layouts=layouts[c], device=dev)
        a = 1.0 if alive[c] else 0.0
        sent, _ = distributed.filter_push(fam, deltas, dcfg.filter,
                                          device_mod.fold_in(key_c, 7))
        sent = {n: sent[n] * a for n in fam.delta_names}
        total = sent if total is None else {n: total[n] + sent[n]
                                            for n in total}
        if lag is not None:
            rows.append({n: lag[n][c] + deltas[n] * a for n in lag})
        out.append(loc)
    stats = projection.project(
        fam.stats_dict(fam.apply_delta(canonical, total)), fam.shared_rules,
        fam.aggregates)
    state2 = server.accumulate_mass(
        server.load_dense(state, fam.shared_from_dict(stats)), total)
    if lag is not None:
        lag = {n: torch.stack([r[n] for r in rows]) for n in lag}
    clocks = state.clocks + torch.tensor(alive, dtype=torch.int32,
                                         device=state.clocks.device)
    return out, state2._replace(cache=cache, cache_version=version,
                                client_lag=lag, clocks=clocks)


def state_digests(fam, server, state, locals_) -> dict:
    """SHA-256 of every shared statistic, of each given client's locals
    and of the row mass; the clocks and the cache version as they are."""
    out = {f"stats/{n}": sha(v)
           for n, v in fam.stats_dict(server.assemble(state)).items()}
    for c, loc in locals_.items():
        out.update({f"local{c}/{f}": sha(v)
                    for f, v in loc._asdict().items()})
    for n, v in (state.client_lag or {}).items():
        out[f"lag/{n}"] = sha(v)
    out["row_mass"] = sha(torch.cat(state.row_mass))
    out["clocks"] = state.clocks.tolist()
    out["cache_version"] = int(state.cache_version)
    return out


def states_differ(fam, server, a, b) -> list[str]:
    """The names of what differs, bit for bit on the device, between two
    (local, server state) pairs."""
    (la, sa), (lb, sb) = a, b
    pairs = [(f"stats/{n}", v, fam.stats_dict(server.assemble(sb))[n])
             for n, v in fam.stats_dict(server.assemble(sa)).items()]
    pairs += [(f"local/{f}", v, getattr(lb, f))
              for f, v in la._asdict().items()]
    pairs += [(f"lag/{n}", v, sb.client_lag[n])
              for n, v in (sa.client_lag or {}).items()]
    pairs += [("row_mass", torch.cat(sa.row_mass), torch.cat(sb.row_mass)),
              ("clocks", sa.clocks, sb.clocks)]
    out = [name for name, x, y in pairs if not torch.equal(x, y)]
    if sa.cache_version != sb.cache_version:
        out.append("cache_version")
    return out


COLLECTIVE = re.compile(
    r"(all_reduce|all_gather|reduce_scatter|all_to_all) (.*) \((\d+) B\)")


def collective_spans(events) -> list[dict]:
    """The collectives of a profiled call in order, from the ranges that
    ``core.collectives`` opens ("<op> <what> (<bytes> B)", bytes this
    rank's input): ``host_ms`` the host's time in the call (the whole of a
    gloo collective, the enqueue of an NCCL one), ``device_ms`` the range's
    device-side copy (NCCL's kernel; None where the trace holds none)."""
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        m = COLLECTIVE.fullmatch(e.name)
        if m is None:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if e.device_type == cuda:
            device.setdefault(e.name, []).append(ms)
        else:
            host.append((m, ms))
    out, seen = [], {}
    for m, ms in host:
        i = seen[m[0]] = seen.get(m[0], -1) + 1
        on_device = device.get(m[0], [])
        out.append({"op": m[1], "what": m[2], "bytes": int(m[3]),
                    "host_ms": ms, "device_ms": on_device[i]
                    if i < len(on_device) else None})
    return out


def mesh_profile(fn) -> tuple:
    """``fn()`` in a padded ``profile_window``: (its result, {its wall ms,
    the device's busy ms and idle share as ``profile_round`` counts them
    (None where the trace held no device-side copy of the call's range),
    its collectives})."""
    result, wall, by_name, ranged, events = profile_window(fn)
    busy = sum(ms for name, (ms, _) in by_name.items()
               if not COLLECTIVE.fullmatch(name)) if ranged else None
    return result, {"wall_ms": wall, "busy_ms": busy,
                    "idle_share": None if busy is None
                    else max(0.0, 1 - busy / wall),
                    "collectives": collective_spans(events)}


def launches_are(label: str, counts: dict, want: dict) -> None:
    """Fail unless each kernel of ``want`` launched exactly that often."""
    for name, n in want.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{counts.get(name, 0)} times, expected {n}")


def collective_line(label: str, spans: list, ranks: int) -> None:
    for rec in spans:
        dev_ms = ("not traced" if rec["device_ms"] is None
                  else f"{rec['device_ms']:.2f} ms")
        print(f"MESH {label} collective {rec['what']} {rec['op']} over "
              f"{ranks} ranks: {rec['bytes']} B, host {rec['host_ms']:.2f} "
              f"ms, device {dev_ms}", flush=True)


def mesh_kernel_checks(label: str, inputs: dict) -> dict:
    """Phase 15a's kernels against their plain versions at the shapes of
    one client of all 65,536 documents, which no earlier phase gives
    them, on the inputs ``KernelTap`` kept from a real round: kernel 1 or
    4 on the first ``SWEEP_SLICE`` (``PDP_SWEEP_SLICE``) positions of the
    first sorted chunk whose documents lie in the upper half of n_dk (the
    rows beyond a two-client shard's), at the tolerance of phases 3 and 5;
    the list build on the whole n_dk, bit for bit; kernels 8 and 9 on the
    first scan position, B = every document (``scan_kernel_figures``)."""
    from repro_torch.core import mhw, pdp
    from repro_torch.kernels import mhw_fused as kmf

    out = {}
    for name, plain, n, first in (
            ("mhw_sweep_fused", mhw.sorted_chain, SWEEP_SLICE, 7),
            ("pdp_sweep_fused", pdp.sorted_chain_pdp, PDP_SWEEP_SLICE, 10)):
        if name not in inputs:
            continue
        args, kw = inputs[name]
        rows, docs, z0, n_dk = args[first:first + 4]
        pick = torch.nonzero(docs >= n_dk.shape[0] // 2).squeeze(1)[:n]
        if pick.numel() == 0:
            raise AssertionError(f"{label}: no position of the chunk lies "
                                 "in n_dk's upper half")
        sliced = (*args[:first], rows[pick], docs[pick], z0[pick], n_dk,
                  *(u[:, pick] for u in args[first + 4:]))
        got = getattr(kmf, name)(*sliced, **kw)
        want = plain(*sliced, **kw)
        mismatch = float((got != want).float().mean())
        out[name] = {"positions": int(pick.numel()),
                     "chunk_positions": int(rows.numel()),
                     "first_doc": int(docs[pick].min()),
                     "n_dk_rows": int(n_dk.shape[0]),
                     "mismatch_rate": mismatch,
                     "max_abs_err": int((got - want).abs().max())}
        # As in phases 3 and 5: only rounding (the kernel's 32-block cdf,
        # log() near an accept tie) can make a chain differ.
        if not mismatch <= SWEEP_MISMATCH_TOL:
            raise AssertionError(f"{label}: {name} differs from plain in "
                                 f"{mismatch:.3g} of chains "
                                 f"(> {SWEEP_MISMATCH_TOL})")
        del got, want
        doc_list_check(n_dk)
        out["doc_topic_lists"] = {"n_dk_rows": int(n_dk.shape[0]),
                                  "bit_equal": True}
    if "alias_sample" in inputs:
        out.update(scan_kernel_figures(
            label, inputs, inputs["alias_sample"][0].prob.shape[1]))
    print(f"MESH {label} kernels against plain {json.dumps(out)}",
          flush=True)
    return out


def mesh_path(label, cfg, dcfg, rounds, shards, ho, dev, mesh, kernels,
              want: dict, falls_: bool,
              profiled: bool = True) -> tuple[dict, dict]:
    """Phase 15a's path: ``rounds`` mesh rounds at world size 1 on NCCL, the
    proposal refreshed when due (every round; under SSP when the cache
    is), each bit-equal to :func:`composed_round` from the same key, exact
    and without violations; the first composed round's kernel inputs
    checked (``mesh_kernel_checks``); the launch counters zeroed just
    before and read just after (the composed rounds' and the checks'
    launches left out); the last round profiled where ``profiled``."""
    from repro_torch import device as device_mod
    from repro_torch.core import distributed, family
    from repro_torch.kernels import _build

    fam = family.get(dcfg.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    locals_, shared = mesh_init(fam, cfg, shards)
    server = distributed.make_server(cfg, dcfg)
    state = server.init_state(shared, len(shards))
    del shared
    layouts = [fam.build_sorted_layouts(cfg, t, m)
               if dcfg.layout == "sorted" else None for t, m in shards]
    round_fn = distributed.make_round_fn(cfg, dcfg, mesh, server=server,
                                         device=dev)
    ho_t = tuple(torch.as_tensor(x, device=dev) for x in ho)
    local = locals_[0]
    del locals_
    _build.reset_launches()
    ms, ppl, checks, profile = [], [], None, None
    for r in range(rounds):
        if (r == 0 or not server.policy.caches
                or server.policy.needs_refresh(r, state.cache_version)):
            state = server.refresh_proposal(cfg, state)
        saved = dict(_build.LAUNCHES)
        tap = KernelTap() if r == 0 else contextlib.nullcontext()
        with tap:
            ref_locals, ref_state = composed_round(
                fam, server, cfg, dcfg, [local], state, shards, layouts,
                (1, r), [True], dev)
        if r == 0:
            # The checks' tensors go back to the allocator's cache, which
            # the rounds reuse; the peak is the rounds' own.
            checks = mesh_kernel_checks(label, tap.inputs)
            del tap
            torch.cuda.reset_peak_memory_stats()
        restore_counts(saved)

        def step():
            return round_fn(local, state, *shards[0], (1, r), [True])
        torch.cuda.synchronize()
        t = time.perf_counter()
        if r == rounds - 1 and profiled:
            (local, state), profile = mesh_profile(step)
        else:
            local, state = step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        differ = states_differ(fam, server, (local, state),
                               (ref_locals[0], ref_state))
        if differ:
            raise AssertionError(f"{label} round {r}: {differ} differ from "
                                 "the composed round")
        del ref_locals, ref_state
        stats = fam.stats_dict(server.assemble(state))
        counted = fam.count_stats(cfg, *shards[0], local)
        err = max(float((counted[n] - stats[n]).abs().max())
                  for n in fam.conserved_stats)
        viol = fam.count_violations(server.assemble(state))
        local_viol = fam.count_local_violations(local)
        ppl.append(fam.perplexity(cfg, server.assemble(state), *ho_t,
                                  (0, device_mod.EVAL, 42)))
        print(f"MESH {label} round {r} "
              f"{ms[-1] if profile is None else profile['wall_ms']:.2f} ms "
              f"clocks={state.clocks.tolist()} cache_version="
              f"{state.cache_version} consistency_error={err} violations="
              f"{viol} local_violations={local_viol} heldout_perplexity="
              f"{ppl[-1]:.3f} equal_to_composed=True", flush=True)
        if err != 0.0 or viol != 0 or local_viol != 0:
            raise AssertionError(f"{label} round {r}: consistency {err}, "
                                 f"violations {viol}, local {local_viol}")
        if not np.isfinite(ppl[-1]):
            raise AssertionError(f"{label}: perplexity {ppl[-1]}")
    counts = dict(_build.LAUNCHES)
    if falls_ and not ppl[-1] < ppl[0]:
        raise AssertionError(f"{label}: perplexity did not fall: {ppl}")
    path_counts_of(label, counts, kernels)
    launches_are(label, counts, want)
    if profile is not None:
        collective_line(label, profile["collectives"], 1)
    n_tok = sum(int(m.sum()) for _, m in shards)
    summary = {"rounds": rounds, "round_ms": ms,
               "median_round_ms": statistics.median(ms),
               "tokens_per_s": n_tok / (sum(ms) / len(ms) / 1e3),
               "profiled_round": profile, "perplexity": ppl,
               "kernels_against_plain": checks, "launches": counts,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "clocks": state.clocks.tolist(),
               "cache_version": state.cache_version}
    print(f"MESH {label} {json.dumps(summary)}", flush=True)
    return counts, summary


def mesh_world1(cfg, pcfg, hcfg, tokens, mask, ho, ho_hdp, dev,
                root: Path) -> tuple[dict, dict]:
    """Phase 15a: the mesh round at world size 1 on NCCL, one client of all
    65,536 documents: LDA sorted (3 rounds), LDA sorted under SSP(1) (3),
    PDP sorted (2) and HDP on the scan layout (2)."""
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.launch.mesh import make_host_mesh

    root.mkdir(parents=True, exist_ok=True)
    store = root / "nccl_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    counts, summaries = {}, {}
    try:
        mesh = make_host_mesh(1, 1, device=dev)
        # NCCL builds a communicator at a group's first collective: one
        # element on each axis first, so no timed round pays for it.
        t = time.perf_counter()
        for axis in ("data", "model"):
            dist.all_reduce(torch.ones(1, device=dev),
                            group=mesh.get_group(axis))
        torch.cuda.synchronize()
        print(f"MESH nccl communicators {(time.perf_counter() - t) * 1e3:.1f}"
              " ms (first collective of each axis, before the paths)",
              flush=True)
        shards = [(torch.as_tensor(tokens, device=dev),
                   torch.as_tensor(mask, device=dev))]
        chunks = cfg.sorted_chunks
        l = tokens.shape[1]
        for label, mcfg, dcfg, rounds, h, kernels, want, falls_ in (
                ("mesh-lda", cfg, distributed.DistConfig(
                    model="lda", layout="sorted"), 2, ho,
                 ("mhw_sweep_fused", "doc_topic_lists", "alias_build"),
                 {"mhw_sweep_fused": 2 * chunks, "alias_build": 2}, True),
                ("mesh-lda-ssp1", cfg, distributed.DistConfig(
                    model="lda", layout="sorted", consistency="ssp:1"), 3,
                 ho, ("mhw_sweep_fused", "doc_topic_lists", "alias_build"),
                 {"mhw_sweep_fused": 3 * chunks, "alias_build": 2}, True),
                ("mesh-pdp", pcfg, distributed.DistConfig(
                    model="pdp", layout="sorted"), 2, ho,
                 ("pdp_sweep_fused", "doc_topic_lists", "alias_build"),
                 {"pdp_sweep_fused": 2 * pcfg.sorted_chunks,
                  "alias_build": 2}, False),
                ("mesh-hdp-scan", hcfg, distributed.DistConfig(
                    model="hdp"), 2, ho_hdp,
                 ("alias_build", "alias_sample", "mh_accept"),
                 {"alias_sample": 2 * l * hcfg.mh_steps,
                  "mh_accept": 2 * l * hcfg.mh_steps}, False)):
            t = time.perf_counter()
            # mesh-hdp-scan's round moves what mesh-lda's profiled round
            # shows; its scan round's trace costs ~15 s of host time
            counts[label], summaries[label] = mesh_path(
                label, mcfg, dcfg, rounds, shards, h, dev, mesh, kernels,
                want, falls_, profiled=label != "mesh-hdp-scan")
            torch.cuda.empty_cache()
            path_seconds("15", label, t)
    finally:
        dist.destroy_process_group()
    return counts, summaries


def load_shards(root: str, dev) -> list:
    return [(torch.as_tensor(np.load(f"{root}/tokens{c}.npy"), device=dev),
             torch.as_tensor(np.load(f"{root}/mask{c}.npy"), device=dev))
            for c in range(2)]


def sync_deltas(fam, server, cfg, dcfg, state, local, shard, c, dev):
    """Client c's delta of one more sweep against ``state``, keyed
    (MESH_SYNC_KEY, c): the real delta phase 15b compresses."""
    from repro_torch.core import distributed
    _, deltas = distributed.client_round(
        cfg, fam, dcfg, local, server.assemble(state), state.tables,
        state.stale, *shard, (MESH_SYNC_KEY, c),
        sorted_layouts=fam.build_sorted_layouts(cfg, *shard), device=dev)
    return deltas["n_wk"]


def mesh_rank(mesh, dev, root: str, cfg, plan) -> dict:
    """Phase 15b on one rank of the 2x2 gloo mesh (tensors on the card):
    each run of ``plan`` from the initial state, the proposal refreshed
    before each round, digests of the state after each, rank 0's last
    round of the first run profiled (its collectives read from the trace);
    then ``sync_compressed`` of each client's next delta, profiled on
    rank 0."""
    import torch.distributed as dist

    from repro_torch.core import distributed, family, ps
    from repro_torch.kernels import _build

    fam = family.get("lda")
    c, me = mesh.get_local_rank("data"), dist.get_rank()
    shards = load_shards(root, dev)
    out: dict = {"runs": {}, "rank": me, "client": c}
    for run, (label, n_shards, plan_alive) in enumerate(plan):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        locals_, shared = mesh_init(fam, cfg, shards)
        local = locals_[c]
        del locals_
        dcfg = distributed.DistConfig(model="lda", layout="sorted",
                                      n_server_shards=n_shards)
        server = distributed.make_server(cfg, dcfg)
        state = server.init_state(shared, 2)
        del shared
        round_fn = distributed.make_round_fn(cfg, dcfg, mesh, server=server,
                                             device=dev)
        _build.reset_launches()
        rounds = []
        for r, alive in enumerate(plan_alive):
            state = server.refresh_proposal(cfg, state)
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            profile = None
            if me == 0 and run == 0 and r == len(plan_alive) - 1:
                (local, state), profile = mesh_profile(
                    lambda: round_fn(local, state, *shards[c], (run, r),
                                     alive))
            else:
                local, state = round_fn(local, state, *shards[c], (run, r),
                                        alive)
            torch.cuda.synchronize()
            rounds.append({"ms": (time.perf_counter() - t) * 1e3,
                           "profile": profile,
                           "digests": state_digests(fam, server, state,
                                                    {c: local})})
        out["runs"][label] = {
            "rounds": rounds, "launches": dict(_build.LAUNCHES),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    state = server.refresh_proposal(cfg, state)
    delta = sync_deltas(fam, server, cfg, dcfg, state, local, shards[c], c,
                        dev)
    dist.barrier()
    torch.cuda.synchronize()
    t = time.perf_counter()

    def sync():
        return distributed.sync_compressed(
            delta, ps.FilterSpec("topk", **TOPK), (MESH_SYNC_KEY, 7, c),
            mesh.get_group("data"))
    profile = None
    if me == 0:
        summed, profile = mesh_profile(sync)
    else:
        summed = sync()
    torch.cuda.synchronize()
    out["sync"] = {"ms": (time.perf_counter() - t) * 1e3,
                   "profile": profile, "digest": sha(summed),
                   "rows": int(summed.ne(0).any(1).sum())}
    return out


def mesh_gloo(cfg, tokens, mask, dev, root: Path) -> tuple[dict, dict]:
    """Phase 15b: the 2x2 mesh over gloo, four processes with their tensors
    on the one card (NCCL refuses two ranks on one device), phase 4's LDA
    at full width as two clients of 32,768 documents: ``MESH_PLAN``'s
    runs, every rank's state bit-equal to every other's and to the rounds
    composed in this process from the same keys, exact on the rounds with
    every client live, clocks as the rule gives; then
    ``sync_compressed`` of each client's next delta, top-k 16,384 + 1,024
    rows, equal to the sum of each client's ``decompress_delta``.  The
    shards reach the ranks as files under ``root``, deleted after."""
    import shutil

    from repro_torch import device as device_mod
    from repro_torch.core import distributed, family, ps
    from repro_torch.data.synthetic import shard_corpus
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_on_mesh

    t_path = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    for c, (t, m) in enumerate(shard_corpus(tokens, mask, 2)):
        np.save(root / f"tokens{c}.npy", t)
        np.save(root / f"mask{c}.npy", m)
    fam = family.get("lda")
    shards = load_shards(str(root), dev)
    layouts = [fam.build_sorted_layouts(cfg, t, m) for t, m in shards]
    saved = dict(_build.LAUNCHES)
    expect = {}
    for run, (label, n_shards, plan_alive) in enumerate(MESH_PLAN):
        locals_, shared = mesh_init(fam, cfg, shards)
        dcfg = distributed.DistConfig(model="lda", layout="sorted",
                                      n_server_shards=n_shards)
        server = distributed.make_server(cfg, dcfg)
        state = server.init_state(shared, 2)
        del shared
        expect[label] = []
        for r, alive in enumerate(plan_alive):
            state = server.refresh_proposal(cfg, state)
            locals_, state = composed_round(fam, server, cfg, dcfg, locals_,
                                            state, shards, layouts, (run, r),
                                            alive, dev)
            if all(alive):
                stats = fam.stats_dict(server.assemble(state))
                count = sum(fam.count_stats(cfg, t, m, loc)["n_wk"]
                            for (t, m), loc in zip(shards, locals_))
                err = float((count - stats["n_wk"]).abs().max())
                if err != 0.0:
                    raise AssertionError(f"{label} round {r}: consistency "
                                         f"{err}")
            expect[label].append(state_digests(fam, server, state,
                                               dict(enumerate(locals_))))
    want_clocks = {"mesh-2x2-alg2": [2, 2], "mesh-2x2-alg1": [2, 1]}
    state = server.refresh_proposal(cfg, state)
    spec = ps.FilterSpec("topk", **TOPK)
    want_sync = None
    for c in range(2):
        delta = sync_deltas(fam, server, cfg, dcfg, state, locals_[c],
                            shards[c], c, dev)
        part = ps.decompress_delta(ps.compress_delta(
            delta, spec, device_mod.generator((MESH_SYNC_KEY, 7, c), dev)),
            cfg.vocab_size, cfg.n_topics)
        want_sync = part if want_sync is None else want_sync + part
    want_sync = sha(want_sync)
    restore_counts(saved)
    del locals_, state, layouts
    torch.cuda.empty_cache()
    path_seconds("15", "2x2 composed rounds and sync (this process)",
                 t_path)

    t = time.perf_counter()
    ranks = run_on_mesh(mesh_rank, 2, 2, device=dev, backend="gloo",
                        args=(str(root), cfg, MESH_PLAN),
                        timeout=MESH_TIMEOUT_S)
    launched_s = path_seconds("15", "2x2 ranks (run_on_mesh)", t)
    counts, summaries = {}, {}
    n_tok = int(mask.sum())
    for label, _, plan_alive in MESH_PLAN:
        for r in range(len(plan_alive)):
            for res in ranks:
                got = res["runs"][label]["rounds"][r]["digests"]
                want = {k: v for k, v in expect[label][r].items()
                        if not k.startswith("local")
                        or k.startswith(f"local{res['client']}/")}
                if got != want:
                    bad = sorted(k for k in want if got.get(k) != want[k])
                    raise AssertionError(f"{label} round {r} rank "
                                         f"{res['rank']}: {bad} differ from "
                                         "the composed round")
        clocks = ranks[0]["runs"][label]["rounds"][-1]["digests"]["clocks"]
        if clocks != want_clocks[label]:
            raise AssertionError(f"{label}: clocks {clocks}, expected "
                                 f"{want_clocks[label]}")
        r0 = ranks[0]["runs"][label]["rounds"]
        ms = [x["ms"] for x in r0 if x["profile"] is None]
        launched: dict = {}
        for res in ranks:
            for name, n in res["runs"][label]["launches"].items():
                launched[name] = launched.get(name, 0) + n
        path_counts_of(label, launched, ("mhw_sweep_fused",
                                         "doc_topic_lists", "alias_build"))
        n_rounds = len(plan_alive)
        launches_are(label, launched, {
            "alias_build": 4 * n_rounds,
            "mhw_sweep_fused": 4 * n_rounds * cfg.sorted_chunks})
        counts[label] = launched
        for x in r0:
            print(f"MESH {label} round {r0.index(x)} rank 0 {x['ms']:.2f} ms "
                  f"clocks={x['digests']['clocks']} equal_across_ranks=True "
                  "equal_to_composed=True", flush=True)
        profiled = next((x["profile"] for x in r0 if x["profile"]), None)
        if profiled:
            collective_line(label, profiled["collectives"], 2)
        summaries[label] = {
            "rounds": n_rounds, "round_ms_rank0": [x["ms"] for x in r0],
            "median_round_ms": statistics.median(ms),
            "tokens_per_s": n_tok / (sum(ms) / len(ms) / 1e3),
            "profiled_round_rank0": profiled,
            "peak_gib_by_rank": [res["runs"][label]["peak_gib"]
                                 for res in ranks],
            "launches": launched, "clocks": clocks}
        print(f"MESH {label} {json.dumps(summaries[label])}", flush=True)
    for res in ranks:
        if res["sync"]["digest"] != want_sync:
            raise AssertionError(f"sync_compressed on rank {res['rank']} "
                                 "differs from the sum of the clients' "
                                 "decompressed deltas")
    summaries["sync_compressed"] = {
        "rows_nonzero": ranks[0]["sync"]["rows"],
        "ms_by_rank": [res["sync"]["ms"] for res in ranks],
        "profiled_rank0": ranks[0]["sync"]["profile"]}
    collective_line("sync_compressed",
                    ranks[0]["sync"]["profile"]["collectives"], 2)
    print(f"MESH sync_compressed {json.dumps(summaries['sync_compressed'])}"
          f" run_on_mesh {launched_s:.1f} s", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return counts, summaries


# ---------------------------------------------------------------------------
# Phase 16: the LM side (models, one-card AdamW training, prefill, decode)
# ---------------------------------------------------------------------------

BF16_TENSOR_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores, data sheet
# 16a: smollm-360m at full width and depth, the launcher's schedule.
LM_TRAIN = {"arch": "smollm-360m", "batch": 8, "seq": 512, "steps": 20,
            "decode": 16, "peak_lr": 1e-3, "warmup": 6}
# 16b: the other nine at full width, depth cut to 1 layer (zamba2: one
# group of 6 Mamba-2 layers and its shared block; whisper: 1 encoder and 1
# decoder layer), batch 2 × 512.
LM_DEPTH = {"zamba2-2.7b": {"n_layers": 6},
            "whisper-large-v3": {"n_layers": 1, "encoder_layers": 1}}
LM_BATCH = (2, 512)
# Those whose 16-bytes-a-parameter training state at that depth stays under
# ~40 GB take a train step at full width; every one takes one at reduced().
LM_FULL_TRAIN = ("qwen2-1.5b", "qwen3-14b", "stablelm-1.6b", "rwkv6-3b",
                 "whisper-large-v3", "zamba2-2.7b")
LM_MULTI_DECODE = ("mixtral-8x7b", "rwkv6-3b", "zamba2-2.7b")
# Decode against forward.  In bf16 the two paths round in different orders
# (a decode step's one-row products; the SSMs' chunked against stepwise f32
# recurrence, rounded to bf16), so their logits part by a gap: at most
# 0.012 (smollm) to 0.175 (zamba2) on a row on an H100 (80GB HBM3, 700 W).
# A top-2 margin below twice a row's gap may flip its argmax on that noise
# alone, so "argmax equal wherever the margin exceeds 1e-2" would fail on a
# near tie.  The check: every row's correlation above DECODE_CORR and its
# largest gap within DECODE_GAP of its logits' range; the argmax flips on
# rows whose margin exceeds ARGMAX_MARGIN are counted and printed (each
# within its row's noise, as the gap bounds it).
ARGMAX_MARGIN, DECODE_CORR, DECODE_GAP = 1e-2, 0.99, 0.1
MICROBATCH_TOL = 5e-2        # tests/test_arch_smoke.py's bound
# The f32-kept product (``layers.einsum_f32``; on the card ``_F32Product``,
# bf16 operands into one GEMM with a float32 result) and its backward
# against the widened float32 product (TF32 off), at 16a's MLP gate and
# attention scores and at that gate over eight experts (the experts'
# grouped spec, whose batch letter is not the output's first).  Both sum
# the same exact products in other orders: |got - want| <=
# ``layers.f32_sum_bound`` (2·k·2^-24·(|a|·|b|) elementwise for a sum of
# k terms), and a gradient, rounded to bf16 once, one bf16 ulp (at most
# 2^-7 of it) more.
F32_PRODUCT_REPS = 10


def lm_inputs(cfg, b: int, s: int, seed: int, dev) -> dict:
    """``lm_batches``'s affine tokens (b, s) on the card, plus the VLM's
    patch embeddings or the audio frames: random bf16 from ``seed``."""
    from repro_torch.data.synthetic import lm_batches

    tokens = next(lm_batches(cfg.vocab_size, b, s, 1, seed=seed,
                             kind="affine"))["tokens"]
    out = {"tokens": torch.as_tensor(tokens, device=dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn(
            (b, cfg.n_patches, cfg.vision_dim), generator=gen,
            device=dev).to(torch.bfloat16)
    if cfg.family == "audio":
        out["frames"] = torch.randn((b, cfg.n_frames, cfg.d_model),
                                    generator=gen, device=dev).to(
                                        torch.bfloat16)
    return out


def synced_ms(fn):
    """(result, ms) of ``fn()`` on the host's clock, closed by a sync."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def decode_check(label, cfg, params, batch, s: int, n: int) -> dict:
    """Prefill of ``s`` tokens, then ``n`` decode steps fed the next
    tokens, against the forward (causal, so its positions up to s + n - 1
    see what the decode saw; ``batch`` holds a multiple of 64 tokens, the
    SSMs' chunk), by the rule stated beside ARGMAX_MARGIN."""
    from repro_torch.models import model

    v = cfg.vocab_size
    with torch.no_grad():
        hidden, _ = model.forward(cfg, params, batch, remat=False)
        want = model.logits_fn(cfg, params, hidden[:, s - 1:s + n])
    del hidden
    want = want[..., :v].float().cpu().numpy()
    pre = dict(batch, tokens=batch["tokens"][:, :s])
    (first, cache), prefill_ms = synced_ms(
        lambda: model.prefill(cfg, params, pre, s + n))
    got, step_ms = [first], []
    for i in range(n):
        (logits, cache), ms = synced_ms(lambda: model.decode_step(
            cfg, params, cache, batch["tokens"][:, s + i:s + i + 1]))
        got.append(logits)
        step_ms.append(ms)
    if int(cache["pos"]) != s + n:
        raise AssertionError(f"{label}: cache pos {int(cache['pos'])}")
    got = torch.cat(got, 1)[..., :v].float().cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite decode logits")
    got, want = got.reshape(-1, v), want.reshape(-1, v)
    top2 = np.sort(want, -1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    gap = np.abs(got - want).max(-1)
    rel_gap = gap / (want.max(-1) - want.min(-1))
    decided = margin > ARGMAX_MARGIN
    flips = decided & (got.argmax(-1) != want.argmax(-1))
    corr = min(np.corrcoef(g, w)[0, 1] for g, w in zip(got, want))
    out = {"prefill_tokens": s, "decode_steps": n,
           "prefill_ms": prefill_ms, "decode_ms": step_ms,
           "rows": len(margin), "max_gap": float(gap.max()),
           "max_rel_gap": float(rel_gap.max()),
           "argmax_decided": int(decided.sum()),
           "argmax_flips": int(flips.sum()), "min_corr": float(corr)}
    if corr <= DECODE_CORR or out["max_rel_gap"] > DECODE_GAP:
        raise AssertionError(f"{label}: decode against forward {out}")
    return out


def f32_product_check(dev, card: str) -> dict:
    """Phase 16's check of the f32-kept product on the card (see
    F32_PRODUCT_REPS): the forward and both gradients of
    ``layers.einsum_f32`` on bf16 operands against the widened float32
    product's, each as the largest ratio of its gap to its bound (≤ 1),
    and the ms of each (CUDA events, the median of F32_PRODUCT_REPS)."""
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models import layers

    cfg = ARCHITECTURES[LM_TRAIN["arch"]]
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    cases = {"mlp gate": ("bsd,df->bsf", (b, s, cfg.d_model),
                          (cfg.d_model, cfg.d_ff)),
             "attention scores": ("bqgrh,bkgh->bgrqk",
                                  (b, s, kv, cfg.n_heads // kv, hd),
                                  (b, s, kv, hd)),
             "grouped experts": ("gecd,edf->gecf", (1, 8, s, cfg.d_model),
                                 (8, cfg.d_model, cfg.d_ff))}
    print("LM 16 f32 products: tolerance |got - want| <= 2·k·2^-24·(|a|·|b|)"
          " elementwise (two float32 sums of k exact products), a bf16 "
          "gradient one bf16 ulp (at most 2^-7 of it) more", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    out = {}
    for name, (spec, sa, sb) in cases.items():
        ins, o = spec.split("->")
        s_x, s_w = ins.split(",")
        size = dict(zip(s_x, sa)) | dict(zip(s_w, sb))
        k = math.prod(size[c] for c in set(s_x) & set(s_w) - set(o))
        x = torch.randn(sa, generator=gen, device=dev).bfloat16()
        w = (torch.randn(sb, generator=gen, device=dev)
             / math.sqrt(k)).bfloat16()

        def run(widen: bool):
            xa = (x.float() if widen else x).requires_grad_()
            wa = (w.float() if widen else w).requires_grad_()
            y = torch.einsum(spec, xa, wa) if widen else \
                layers.einsum_f32(spec, xa, wa)
            return y, xa, wa

        y, xa, wa = run(False)
        if type(y.grad_fn).__name__ != "_F32ProductBackward":
            raise AssertionError(f"16 {name}: einsum_f32 took "
                                 f"{type(y.grad_fn).__name__}")
        ct = torch.randn(y.shape, generator=gen, device=dev)
        got = (y,) + torch.autograd.grad(y, (xa, wa), ct)
        y32, xw, ww = run(True)
        want = (y32,) + torch.autograd.grad(y32, (xw, ww), ct)
        if got[0].dtype != torch.float32 or got[1].dtype != x.dtype or \
                got[2].dtype != w.dtype:
            raise AssertionError(f"16 {name}: dtypes "
                                 f"{[g.dtype for g in got]}")
        tols = (layers.f32_sum_bound(spec, x, w),
                layers.f32_sum_bound(f"{o},{s_w}->{s_x}", ct, w)
                + 2.0 ** -7 * want[1].abs(),
                layers.f32_sum_bound(f"{s_x},{o}->{s_w}", x, ct)
                + 2.0 ** -7 * want[2].abs())
        ratio = [float(((g.detach().float() - v.detach()).abs()
                        / t.clamp_min(1e-30)).max())
                 for g, v, t in zip(got, want, tols)]
        del got, want, tols, y, y32

        def fwd(widen):
            return lambda: (torch.einsum(spec, x.float(), w.float())
                            if widen else layers.einsum_f32(spec, x, w))

        def fwd_bwd(widen):
            def go():
                y_, xa_, wa_ = run(widen)
                torch.autograd.grad(y_, (xa_, wa_), ct)
            return go

        rec = {"spec": spec, "a": list(sa), "b": list(sb),
               "gap_over_bound": dict(zip(("product", "grad a", "grad b"),
                                          ratio)),
               "ms": {"card": time_ms(fwd(False), F32_PRODUCT_REPS),
                      "widened": time_ms(fwd(True), F32_PRODUCT_REPS),
                      "card fwd+bwd": time_ms(fwd_bwd(False),
                                              F32_PRODUCT_REPS),
                      "widened fwd+bwd": time_ms(fwd_bwd(True),
                                                 F32_PRODUCT_REPS)},
               "card": card}
        print(f"LM 16 f32 product {name} {spec} {list(sa)} x {list(sb)}: "
              "gap over its bound: product {:.3g}, grad a {:.3g}, grad b "
              "{:.3g}; ms (median of {}): card {:.3f}, widened {:.3f}, card "
              "forward+backward {:.3f}, widened {:.3f} on {}".format(
                  *ratio, F32_PRODUCT_REPS, *rec["ms"].values(), card),
              flush=True)
        if max(ratio) > 1:
            raise AssertionError(f"16 {name}: the card's product off the "
                                 f"widened one: {ratio}")
        out[name] = rec
        del x, w, ct
    torch.cuda.empty_cache()
    return out


def lm_smollm(dev, root: Path, card: str, keep: dict | None = None) -> dict:
    """Phase 16a (see the module docstring); its final state, batch and
    schedule go into ``keep`` (on the host) for phase 17a."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig, make_train_step

    a = LM_TRAIN
    cfg = ARCHITECTURES[a["arch"]]
    tcfg = TrainConfig(peak_lr=a["peak_lr"], warmup=a["warmup"],
                       total_steps=a["steps"], loss_chunk=a["seq"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(cfg, seed=0, device=dev)
    opt = adamw.init(params)
    step = make_train_step(cfg, tcfg, device=dev)
    data = list(lm_batches(cfg.vocab_size, a["batch"], a["seq"],
                           a["steps"] + 1, seed=1, kind="affine"))
    losses, ms = [], []
    for i in range(a["steps"]):
        (params, opt, met), t = synced_ms(lambda: step(params, opt, data[i]))
        losses.append(float(met["loss"]))
        ms.append(t)
        if not (np.isfinite(losses[-1]) and np.isfinite(
                float(met["grad_norm"]))):
            raise AssertionError(f"lm-train step {i}: loss {losses[-1]}")
        print(f"LM 16a {cfg.name} step {i} loss={losses[-1]:.4f} "
              f"grad_norm={float(met['grad_norm']):.3f} "
              f"lr={float(met['lr']):.2e} {t:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5:
        raise AssertionError(f"lm-train: loss did not fall: {losses}")
    tokens = a["batch"] * a["seq"]
    step_ms = statistics.median(ms[2:])
    n_active = cfg.active_param_count()
    flops = 6 * n_active * tokens / (step_ms / 1e3)
    summary = {"arch": cfg.name, "batch": a["batch"], "seq": a["seq"],
               "steps": a["steps"], "params": cfg.param_count(),
               "active_params": n_active, "loss_first5": first5,
               "loss_last5": last5, "step_ms_median": step_ms,
               "step_ms": ms, "tokens_per_s": tokens / (step_ms / 1e3),
               "peak_gib": peak, "model_flops_per_s": flops,
               "bf16_peak_share": flops / BF16_TENSOR_FLOPS, "card": card}

    # The checkpoint round trip: restored tensors bit-equal to the saved
    # ones; the next step from them within the spread of two twin steps.
    shutil.rmtree(root, ignore_errors=True)
    tree = {"params": params, "opt": opt._asdict()}
    _, save_ms = synced_ms(lambda: ckpt.save(str(root), cfg.name,
                                             a["steps"], tree))
    back, restore_ms = synced_ms(lambda: ckpt.restore(str(root), cfg.name,
                                                      tree))
    nbytes = sum(f.stat().st_size for f in root.glob("*.npz"))
    shutil.rmtree(root, ignore_errors=True)
    equal = all(torch.equal(x, y.cpu()) for x, y in
                zip(model.leaves(back), model.leaves(tree)))
    if not equal:
        raise AssertionError("lm-train: restored tensors differ")
    del tree

    def on_card(tr):
        return model.map_tree(lambda t_: t_.to(dev), tr)

    def clone(tr):
        return model.map_tree(lambda t_: t_.clone(), tr)

    restored = (on_card(back["params"]),
                adamw.AdamWState(back["opt"]["step"].to(dev),
                                 on_card(back["opt"]["m"]),
                                 on_card(back["opt"]["v"])))
    del back
    twin = (clone(params), adamw.AdamWState(opt.step.clone(), clone(opt.m),
                                            clone(opt.v)))
    halves = (clone(params), adamw.AdamWState(opt.step.clone(),
                                              clone(opt.m), clone(opt.v)))
    nxt = data[-1]
    mb2 = make_train_step(cfg, TrainConfig(
        peak_lr=a["peak_lr"], warmup=a["warmup"], total_steps=a["steps"],
        loss_chunk=a["seq"], microbatches=2), device=dev)
    params, opt, m_a = step(params, opt, nxt)
    p_b, _, m_b = step(*twin, nxt)
    _, _, m_r = step(*restored, nxt)
    _, _, m_2 = mb2(*halves, nxt)
    l_a, l_b, l_r, l_2 = (float(m["loss"]) for m in (m_a, m_b, m_r, m_2))
    twins_equal = all(torch.equal(x, y) for x, y in
                      zip(model.leaves(params), model.leaves(p_b)))
    spread = abs(l_a - l_b)
    del twin, halves, restored, p_b
    summary.update({
        "ckpt": {"bytes": nbytes, "save_s": save_ms / 1e3,
                 "restore_s": restore_ms / 1e3, "bit_equal": equal,
                 "next_loss": l_r, "twin_losses": [l_a, l_b],
                 "twins_bit_equal": twins_equal},
        "microbatches_2": {"loss": l_2, "loss_1": l_a,
                           "rel": abs(l_2 - l_a) / max(1.0, abs(l_a))}})
    if abs(l_r - l_a) > spread:
        raise AssertionError(f"lm-train: resumed step loss {l_r} outside "
                             f"the twins' {l_a}, {l_b}")
    if abs(l_2 - l_a) >= MICROBATCH_TOL * max(1.0, abs(l_a)):
        raise AssertionError(f"lm-train: 2 microbatches {l_2} against 1 "
                             f"{l_a}")

    batch = lm_inputs(cfg, a["batch"], a["seq"] + 64, 2, dev)
    summary["decode"] = decode_check("lm-decode " + cfg.name, cfg, params,
                                     batch, a["seq"], a["decode"])
    if keep is not None:      # phase 17a's state and batch, on the host
        keep.update(params=model.map_tree(lambda t_: t_.cpu(), params),
                    opt=adamw.AdamWState(opt.step.cpu(), model.map_tree(
                        lambda t_: t_.cpu(), opt.m), model.map_tree(
                            lambda t_: t_.cpu(), opt.v)),
                    batch=nxt, tcfg=tcfg)
    del params, opt, batch
    torch.cuda.empty_cache()
    summary["beside"] = BESIDE["16"]
    print(f"LM 16a {cfg.name} {a['batch']}x{a['seq']}: "
          f"{summary['tokens_per_s']:.0f} tokens/s, step {step_ms:.1f} ms "
          f"(median after 2), peak {peak:.2f} GiB, model FLOPs/s "
          f"{flops / 1e12:.1f}T = {summary['bf16_peak_share']:.3f} of the "
          f"bf16 dense peak (989T) on {card}, beside {BESIDE['16']}",
          flush=True)
    print(f"LM 16a step {min(ms):.1f}-{max(ms):.1f} ms, peak {peak:.2f} "
          f"GiB, decode's largest gap {summary['decode']['max_rel_gap']:.4f}"
          " of a row", flush=True)
    print(f"LM 16a {json.dumps(summary)}", flush=True)
    return summary


def lm_full_width(arch: str, seed: int, dev, card: str) -> dict:
    """Phase 16b for one architecture at full width, depth cut: forward,
    prefill and decode against forward, and a train step where it fits."""
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig, make_train_step

    b, s = LM_BATCH
    cfg = ARCHITECTURES[arch].replace(**LM_DEPTH.get(arch, {"n_layers": 1}))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(cfg, seed=seed, device=dev)
    n = 3 if arch in LM_MULTI_DECODE else 1
    batch = lm_inputs(cfg, b, s + 64, 10 + seed, dev)
    fwd_batch = dict(batch, tokens=batch["tokens"][:, :s])
    with torch.no_grad():
        model.forward(cfg, params, fwd_batch, remat=False)      # warm-up
        (hidden, _), fwd_ms = synced_ms(lambda: model.forward(
            cfg, params, fwd_batch, remat=False))
    if not bool(torch.isfinite(hidden).all()):
        raise AssertionError(f"lm {arch}: non-finite hidden states")
    del hidden
    # routing drops depend on the batch: lift the capacity, as the
    # reference's round-trip test does, so forward and decode compare
    dcfg = cfg.replace(capacity_factor=float(cfg.n_experts)) \
        if cfg.n_experts else cfg
    entry = {"config": {k: getattr(cfg, k) for k in (
        "n_layers", "encoder_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "n_experts")},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(), "forward_ms": fwd_ms,
        "forward_tokens_per_s": b * s / (fwd_ms / 1e3),
        "decode": decode_check(f"lm {arch}", dcfg, params, batch, s, n)}
    del batch
    if arch in LM_FULL_TRAIN:
        opt = adamw.init(params)
        step = make_train_step(cfg, TrainConfig(loss_chunk=s), device=dev)
        train_batch = lm_inputs(cfg, b, s, 20 + seed, dev)
        (_, _, met), ms = synced_ms(lambda: step(params, opt, train_batch))
        loss = float(met["loss"])
        if not (np.isfinite(loss) and float(met["grad_norm"]) > 0):
            raise AssertionError(f"lm {arch}: train step {met}")
        flops = 6 * cfg.active_param_count() * b * s / (ms / 1e3)
        entry["train"] = {"step_ms": ms, "loss": loss,
                          "grad_norm": float(met["grad_norm"]),
                          "model_flops_per_s": flops,
                          "bf16_peak_share": flops / BF16_TENSOR_FLOPS}
        del opt, train_batch
    entry["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    train = entry.get("train")
    print(f"LM 16b {arch} (full width, {cfg.n_layers} layers): forward "
          f"{fwd_ms:.1f} ms ({entry['forward_tokens_per_s']:.0f} "
          f"tokens/s), prefill {entry['decode']['prefill_ms']:.1f} ms, "
          f"decode {statistics.median(entry['decode']['decode_ms']):.2f}"
          " ms a step, train "
          + (f"{train['step_ms']:.1f} ms ({train['bf16_peak_share']:.3f}"
             " of the bf16 peak)" if train else "not at full width")
          + f", peak {entry['peak_gib']:.2f} GiB on {card}, beside "
          f"{BESIDE['16']}", flush=True)
    entry["beside"] = BESIDE["16"]
    return entry


def lm_reduced_step(arch: str, seed: int, dev) -> dict:
    """One train step of ``arch`` at ``reduced()`` size on the card, so
    every family's backward runs there."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = reduced(ARCHITECTURES[arch])
    params = model.init_params(cfg, seed=seed, device=dev)
    step = make_train_step(cfg, TrainConfig(loss_chunk=64), device=dev)
    (_, _, met), ms = synced_ms(lambda: step(
        params, adamw.init(params), lm_inputs(cfg, 2, 64, 30 + seed, dev)))
    if not np.isfinite(float(met["loss"])):
        raise AssertionError(f"lm {arch} reduced: train step {met}")
    return {"step_ms": ms, "loss": float(met["loss"])}


def lm_phase(dev, root: Path, card: str, keep: dict | None = None) -> dict:
    """Phase 16: 16a, then 16b (the other nine at full width; all ten at
    reduced() size); returns their summaries."""
    from repro_torch.configs.registry import ARCHITECTURES

    out = {"16 f32 products": f32_product_check(dev, card)}
    out.update({"16a": lm_smollm(dev, root, card, keep), "16b": {}})
    for i, arch in enumerate(sorted(ARCHITECTURES)):
        entry = {} if arch == LM_TRAIN["arch"] else lm_full_width(
            arch, i, dev, card)
        entry["reduced_train"] = lm_reduced_step(arch, i, dev)
        print(f"LM 16b {arch} {json.dumps(entry)}", flush=True)
        out["16b"][arch] = entry
    return out

# ---------------------------------------------------------------------------
# Phase 17: the LM side over a (data, model) mesh
# ---------------------------------------------------------------------------

MESH_LM_MODES = ("megatron", "zero_seq", "zero_batch")
# 17b: smollm-360m at full width, depth cut to 8 layers, 8 x 512 tokens,
# two steps under megatron and one under each zero mode (the time limit)
# on a 2x2 gloo mesh of four processes on the card.
MESH_LM = {"arch": "smollm-360m", "n_layers": 8, "batch": 8, "seq": 512,
           "steps": 2, "peak_lr": 1e-3}
MESH_LM_STEPS = {"megatron": 2, "zero_seq": 1, "zero_batch": 1}
# The mesh against the one-card steps: each bound is MESH_LM_MARGIN times
# the one-card run's own spread (two and four microbatches against one:
# the same sums in the row splits of the mesh's ranks), and at least the
# floor: 2^-8 relative for the loss and the grad norm (bf16's epsilon), and
# 0.05 for the parameters after the last step (Frobenius of the difference
# over that of the update; AdamW's steps amplify a gradient's last bits
# where it changes sign between steps).
MESH_LM_MARGIN = 4.0
MESH_LM_FLOOR = {"loss": 2.0 ** -8, "grad_norm": 2.0 ** -8, "params": 0.05}
# 17c: phi3.5-moe at full width, one layer, zero_batch, one token group a
# rank: the expert-parallel all-to-all.
MESH_MOE = {"arch": "phi3.5-moe-42b-a6.6b", "n_layers": 1, "moe_groups": 4,
            "batch": 4, "seq": 512}
MESH_MOE_TOL = 2.0 ** -7   # a2a block against one process, max |d| / max
# 17c under zero_seq, the same layer, tokens and groups (a group a row): each
# model rank dispatches the rows ``layers.seq_groups`` gives it, their tokens
# and routes exchanged over ``model`` alone.  The block runs on the four
# ranks (2x2: a row a rank); the train step on a 1x2 mesh of two processes
# started after them (MOE_SEQ_STEP_MESH: each rank of a zero_seq step holds
# the layer's whole experts, their float32 copy and gradients: four ranks of
# the 2x2 step ran out of the H100's memory, and the 1x2 step peaks at 19.5
# GiB a rank there; two rows a rank).
# Rank 0's exchanges (input bytes) in that step, as ``tools/
# torch_mesh_tally.py --arch phi3.5-moe-42b-a6.6b --layers 1 --batch 4 --seq
# 512 --mode zero_seq --mesh 1,2`` counts them on a fake group, and the peak
# it reads there (MemTracker).
MOE_SEQ_STEP_MESH = (1, 2)
MOE_SEQ_PREDICTED = {"all_to_all moe seq": 16_777_216,
                     "all_to_all moe seq route": 32_768,
                     "all_to_all moe seq back": 8_388_608,
                     "all_to_all moe seq grad": 8_388_608,
                     "all_to_all moe seq route grad": 16_384,
                     "all_to_all moe seq back grad": 8_388_608}
MOE_SEQ_PEAK_PREDICTED_GIB = 27_331_485_740 / 2**30
MOE_GATHERS = ("all_gather moe tokens", "all_gather moe gates",
               "all_gather moe ids")
# Phase 17's four ranks start before phase 16 (the time limit): they run
# 17b, 18b and 18d beside 17b's one-card side and phase 16, 17d once the
# smoke's process writes PHASE16_DONE (beside 17a and the one-card sides of
# 17c and 17d) and 17c once it writes MAIN_IDLE (alone).  What ran beside
# each measured part, printed with its figures:
PHASE16_DONE, MAIN_IDLE = "phase16-done", "main-idle"
BESIDE = {"16": "phase 17's four ranks (their start, 17b, 18b, 18d)",
          "17b": "the ranks' steps beside phase 16, one card's beside the "
                 "ranks' start and 17b",
          "17d": "the ranks' steps beside 17a and the one-card sides of 17c "
                 "and 17d, which ran beside them",
          "18": "the ranks' prefill and decode beside phase 16",
          "17c step": "phase 18's parts in the smoke's process (18a, the "
                      "one-card sides and checks of 18b and 18d, 18c's "
                      "wait)"}
# 17d: the SSM mixers split by heads over ``model``: rwkv6-3b at published
# widths, 1 layer, and zamba2-2.7b at 6 layers (one group and its shared
# block), 2 x 512 tokens, one megatron step each (8 x 512 of zamba2 peaks at
# 40.9 GB a rank before the split: too much for four ranks on one card).
MESH_SSM = ({"arch": "rwkv6-3b", "n_layers": 1, "batch": 2, "seq": 512,
             "steps": 1, "peak_lr": 1e-3},
            {"arch": "zamba2-2.7b", "n_layers": 6, "batch": 2, "seq": 512,
             "steps": 1, "peak_lr": 1e-3})
# In bf16 one card's own first gradients of zamba2's Mamba-2 leaves part by
# 27-49% between one and two microbatches (relative Frobenius, H100;
# 28-40% with their in-projection in float32 too, which the port still
# rounds; 17d prints its own; ROADMAP C.5),
# too wide to hold the split by: zamba2's step again at float32 compute, at 2 x 128,
# where every leaf must be held (``hold_all``) and the floor is 2^-7 (its
# worst leaf read 1.1e-3 at 2 x 256, H100).
MESH_SSM_F32 = {"arch": "zamba2-2.7b", "n_layers": 6, "batch": 2, "seq": 128,
                "steps": 1, "peak_lr": 1e-3, "float32": True,
                "hold_all": True, "grad_floor": 2.0 ** -7}
# 17d under zero_seq (the sequence split over ``model``: each rank's
# recurrences on its 256 positions, only the rank-boundary states and halos
# exchanged): 17d's two plans, and whisper-large-v3 at published widths
# with one decoder and one encoder layer, its 1,500 frames split 750 + 750.
MESH_SSM_SEQ = tuple(dict(p, mode="zero_seq") for p in MESH_SSM) + (
    {"arch": "whisper-large-v3", "n_layers": 1, "encoder_layers": 1,
     "batch": 2, "seq": 512, "steps": 1, "peak_lr": 1e-3,
     "mode": "zero_seq"},)
SSM_CHECKS = MESH_SSM + (MESH_SSM_F32,) + MESH_SSM_SEQ
# The zero_seq steps' exchanges in a step on rank 0 (input bytes), as
# ``tools/torch_mesh_tally.py --mode zero_seq`` predicts them on a fake
# 2x2 group at the plans' shapes (no (B, S, D) ``sequence in`` or
# ``frames`` gather is left).
SEQ_PREDICTED = {
    "rwkv6-3b zero_seq": {"all_to_all seq state": 1_331_200,
                          "all_to_all seq state grad": 0,
                          "all_to_all seq halo": 20_480,
                          "all_to_all seq halo grad": 0},
    "zamba2-2.7b zero_seq": {"all_to_all seq state": 15_851_520,
                             "all_to_all seq state grad": 0,
                             "all_to_all seq halo": 737_280,
                             "all_to_all seq halo grad": 0},
    "whisper-large-v3 zero_seq": {}}
# The same zero_seq steps' peak GiB a rank before the change (each model
# rank ran the recurrences, and whisper's encoder, on the whole gathered
# sequence): that package's step in a script of these functions alone on
# an H100 80GB HBM3 at 700 W (the largest rank's; the same script on the
# sequence-parallel package read 4.043, 8.075, 2.078).
SEQ_PEAK_BEFORE = {"rwkv6-3b zero_seq": 4.043, "zamba2-2.7b zero_seq": 12.652,
                   "whisper-large-v3 zero_seq": 2.449}
SEQ_GATHERS = ("all_gather sequence in", "all_gather frames")
# 17d's first gradients against one card's, leaf by leaf (AdamW's m after
# the step): each leaf within MESH_LM_MARGIN times one card's own spread
# between one and two microbatches, and at least 2^-4 (relative Frobenius;
# a plan's "grad_floor" where it gives one).
# A leaf is held where that bound is below SSM_GRAD_HELD, so that a
# gradient left at zero (1.0) or reversed (2.0) exceeds it; a leaf whose own
# spread is wider is printed as not held.
SSM_GRAD_FLOOR = 2.0 ** -4
SSM_GRAD_HELD = 0.5


def lm_tcfg(cfg_kw: dict, microbatches: int = 1):
    from repro_torch.train.train_step import TrainConfig
    return TrainConfig(peak_lr=cfg_kw["peak_lr"], warmup=0,
                       total_steps=cfg_kw["steps"], loss_chunk=cfg_kw["seq"],
                       microbatches=microbatches)


def lm_mesh_config(plan: dict):
    from repro_torch.configs.registry import ARCHITECTURES
    kw = {k: plan[k] for k in ("n_layers", "moe_groups", "encoder_layers")
          if k in plan}
    return ARCHITECTURES[plan["arch"]].replace(**kw)


def plan_batches(cfg, plan: dict) -> list:
    """``plan``'s global batches: ``lm_batches``' affine tokens, and for
    an audio model its frames (normal draws, from the batch's index)."""
    from repro_torch.data.synthetic import lm_batches

    out = list(lm_batches(cfg.vocab_size, plan["batch"], plan["seq"],
                          plan["steps"], seed=1, kind="affine"))
    if cfg.family == "audio":
        for i, b in enumerate(out):
            b["frames"] = np.random.default_rng(1700 + i).standard_normal(
                (plan["batch"], cfg.n_frames, cfg.d_model)).astype(
                    np.float32)
    return out


def plan_mode(plan: dict) -> str:
    return plan.get("mode", "megatron")


def plan_hooks(plan: dict):
    """A zero mode's activation spec with no mesh, for one card's side of
    a plan (its blocks then cast to bf16 before use, as on the mesh)."""
    from repro_torch.models import layers
    from repro_torch.train import sharding
    if plan_mode(plan) == "megatron":
        return contextlib.nullcontext()
    return layers.mesh_hooks(sharding.activation_spec(
        {"data": 2, "model": 2}, plan_mode(plan)))


def tree_bytes(*trees) -> int:
    from repro_torch.models import model
    return sum(x.numel() * x.element_size() for t in trees
               for x in model.leaves(t))


def update_err(got: list, want: list, init: list) -> float:
    """max over leaves of ||got - want|| / ||want - init|| (float64)."""
    out = 0.0
    for g, w, i in zip(got, want, init):
        w64 = w.double()
        den = float(torch.linalg.vector_norm(w64 - i.double()))
        if den > 0:
            out = max(out, float(torch.linalg.vector_norm(
                g.double() - w64)) / den)
    return out


def collective_totals(label: str, profile: dict, ranks: int) -> list:
    """A profiled step's collectives summed by (op, what): calls, bytes
    (this rank's inputs) and host ms (the whole of a gloo collective);
    printed a MESH-LM line each."""
    rows: dict = {}
    for c in profile["collectives"]:
        r = rows.setdefault((c["op"], c["what"]), [0, 0, 0.0])
        r[0] += 1
        r[1] += c["bytes"]
        r[2] += c["host_ms"]
    out = [{"op": op, "what": what, "calls": n, "bytes": b, "host_ms": ms}
           for (op, what), (n, b, ms) in sorted(rows.items())]
    for rec in out:
        print(f"MESH-LM {label} collective {rec['op']} {rec['what']} over "
              f"{ranks} ranks: {rec['calls']} calls, {rec['bytes']} B, host "
              f"{rec['host_ms']:.2f} ms of a {profile['wall_ms']:.1f} ms "
              "step", flush=True)
    return out


def step_tally(counts: dict, steps: int) -> dict:
    """A tally's counts a step (integer division of its calls and bytes
    by ``steps``)."""
    return {k: {f: v[f] // steps for f in ("calls", "bytes", "out_bytes")}
            for k, v in counts.items()}


def tally_lines(label: str, counts: dict, model_group: tuple,
                per: str) -> dict:
    """Print a tally a ``per`` (step) by name, the model group's entries
    marked, then its totals: every collective, the weights' gathers and
    the re-layouts; returns those totals and the all-gathers of weights
    over the model group (``model_weight_gathers``)."""
    tag = f"@{model_group}"
    for key, c in sorted(counts.items()):
        name, _, group = key.rpartition(" @")
        over = "model" if key.endswith(tag) else f"ranks {group}"
        print(f"{label} collective {name} over {over}: {c['calls']} calls, "
              f"{c['bytes']} B in, {c['out_bytes']} B out a {per} a rank",
              flush=True)

    def total(keep):
        got = [c for k, c in counts.items() if keep(k)]
        return {"calls": sum(c["calls"] for c in got),
                "bytes": sum(c["bytes"] for c in got),
                "out_bytes": sum(c["out_bytes"] for c in got)}

    out = {"all": total(lambda k: True),
           "weights": total(lambda k: " weights" in k
                            and k.startswith("all_gather")),
           "weights_grad": total(lambda k: " weights grad" in k),
           "relayout": total(lambda k: " relayout " in k),
           "model_weight_gathers": sorted(
               k for k in counts if k.startswith("all_gather")
               and k.endswith(tag) and " weights" in k)}
    for part in ("all", "weights", "weights_grad", "relayout"):
        c = out[part]
        print(f"{label} collectives {part}: {c['calls']} calls, "
              f"{c['bytes']} B in, {c['out_bytes']} B out a {per} a rank",
              flush=True)
    return out


def mesh_lm_world1(dev, state: dict, card: str) -> dict:
    """17a: NCCL at world size 1 in this process: one step in each mode
    from phase 16a's final state on its batch, against the one-card step
    from the same state (under megatron the plain step; under the zero
    modes the step under the mode's activation spec, which holds block
    weights in bf16 as the reference's zero modes do), bit for bit; the
    largest difference to the plain step is printed and explained."""
    import torch.distributed as dist

    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers, model
    from repro_torch.optim import adamw
    from repro_torch.train import sharding
    from repro_torch.train.train_step import make_train_step

    cfg = ARCHITECTURES[LM_TRAIN["arch"]]
    tcfg, batch = state["tcfg"], state["batch"]
    root = ROOT / "build" / "phase17"
    root.mkdir(parents=True, exist_ok=True)
    store = root / "nccl_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)

    on = lambda tr: model.map_tree(lambda t_: t_.to(dev), tr)
    o = state["opt"]
    base = (on(state["params"]),
            adamw.AdamWState(o.step.to(dev), on(o.m), on(o.v)))

    def fresh():              # a copy on the card of 16a's final state
        c = lambda tr: model.map_tree(torch.clone, tr)
        return c(base[0]), adamw.AdamWState(base[1].step.clone(),
                                            c(base[1].m), c(base[1].v))

    def flat(p, o, met):
        return (model.leaves(p) + model.leaves(o.m) + model.leaves(o.v)
                + [o.step] + [met[k] for k in sorted(met)])

    out = {}
    try:
        mesh = make_host_mesh(1, 1, device=dev)
        plain = flat(*make_train_step(cfg, tcfg, device=dev)(*fresh(),
                                                               batch))
        for mode in MESH_LM_MODES:
            step = make_train_step(cfg, tcfg, device=dev, mesh=mesh,
                                   mode=mode)
            start = fresh()
            (p, o, met), ms = synced_ms(lambda: step(*start, batch))
            got = flat(p, o, met)
            del p, o, start
            if mode == "megatron":
                want = plain
            else:
                act = sharding.activation_spec(sharding.axis_sizes(mesh),
                                               mode)
                with layers.mesh_hooks(act):
                    want = flat(*make_train_step(cfg, tcfg, device=dev)(
                        *fresh(), batch))
            differ = [i for i, (x, y) in enumerate(zip(got, want))
                      if not torch.equal(x, y)]
            gap = max(float((x.double() - y.double()).abs().max())
                      for x, y in zip(got, plain))
            del got, want
            out[mode] = {"bit_equal": not differ, "step_ms": ms,
                         "loss": float(met["loss"]),
                         "max_abs_diff_to_plain_step": gap}
            print(f"MESH-LM 17a {mode} world 1 (nccl): bit-equal to the "
                  f"one-card step{'' if mode == 'megatron' else ' under its activation spec'}"
                  f" {not differ}; largest difference to the plain "
                  f"one-card step {gap:.3e}"
                  + ("" if mode == "megatron" else
                     " (the zero modes hold the block weights, norm scales"
                     " included, in bf16, as the reference's do)")
                  + f"; {ms:.1f} ms on {card}", flush=True)
            if differ:
                raise AssertionError(f"17a {mode}: {len(differ)} tensors "
                                     "differ from the one-card step")
    finally:
        dist.destroy_process_group()
    return out


def one_card_runs(dev, plan: dict, root: Path) -> dict:
    """17b's one-card side: per mode, the steps of ``plan`` from the seed's
    weights (zero modes under their activation spec), their metrics, and
    the spread against two and four microbatches; the final parameters of
    the one-microbatch run saved under ``root`` for the ranks."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import layers, model
    from repro_torch.optim import adamw
    from repro_torch.train import sharding
    from repro_torch.train.train_step import make_train_step

    cfg = lm_mesh_config(plan)
    data = list(lm_batches(cfg.vocab_size, plan["batch"], plan["seq"],
                           plan["steps"], seed=1, kind="affine"))
    init = model.leaves(model.init_params(cfg, seed=0, device=dev))
    out = {}
    for mode in MESH_LM_MODES:
        act = sharding.activation_spec({"data": 2, "model": 2}, mode)
        steps = data[:MESH_LM_STEPS[mode]]
        runs = {}
        for mb in (1, 2, 4):
            params = model.init_params(cfg, seed=0, device=dev)
            opt = adamw.init(params)
            step = make_train_step(cfg, lm_tcfg(plan, mb), device=dev)
            mets, ms = [], []
            with layers.mesh_hooks(act):
                for b in steps:
                    (params, opt, m), t_ = synced_ms(
                        lambda: step(params, opt, b))
                    mets.append({k: float(m[k]) for k in ("loss",
                                                          "grad_norm")})
                    ms.append(t_)
            runs[mb] = (mets, model.leaves(params), ms)
            if mb == 1:
                onebytes = tree_bytes(params, opt.m, opt.v)
            del params, opt
        torch.cuda.empty_cache()
        mets1, final1, ms1 = runs[1]
        spread = {k: max(abs(runs[mb][0][s][k] - mets1[s][k])
                         / abs(mets1[s][k]) for mb in (2, 4)
                         for s in range(len(steps)))
                  for k in ("loss", "grad_norm")}
        spread["params"] = max(update_err(runs[mb][1], final1, init)
                               for mb in (2, 4))
        tmp = root / f"{mode}.pt.tmp"
        torch.save([x.cpu() for x in final1], tmp)
        tmp.rename(root / f"{mode}.pt")        # whole, for rank 0
        out[mode] = {"metrics": mets1, "spread": spread,
                     "one_card_bytes": onebytes, "step_ms": ms1}
        del runs, final1
        torch.cuda.empty_cache()
    return out


def mesh_lm_rank(mesh, dev, plan: dict, root: str, sync_spec) -> dict:
    """17b on one rank of the 2x2 gloo mesh (tensors on the card): per
    mode, the steps of ``plan`` from the seed's weights cut to the rank's
    blocks, megatron's last profiled on rank 0; the blocks' shapes against
    their specs, the resident bytes, the peak memory, the parameters
    against the one-card run's (:func:`leaf_sums`; the smoke's process
    writes them under ``root``); then ``make_sync_fns``' top-k
    push of this client's residual, 18b and 18d; then, once the smoke's
    process has written ``PHASE16_DONE``, 17d; then, once it has written
    ``MAIN_IDLE``, 17c (the seconds of each part, waits included).  A
    block compared with one card's waits for the file the one-card side
    writes."""
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import sharding, sync
    from repro_torch.train.train_step import make_train_step, param_layout

    me = dist.get_rank()
    cfg = lm_mesh_config(plan)
    data = list(lm_batches(cfg.vocab_size, plan["batch"], plan["seq"],
                           plan["steps"], seed=1, kind="affine"))
    out = {"rank": me, "modes": {}, "seconds": {}}
    t = time.perf_counter()
    for mode in MESH_LM_MODES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        specs = param_layout(cfg, mesh, mode)
        params = sharding.shard_tree(model.init_params(cfg, seed=0,
                                                       device=dev),
                                     specs, mesh)
        init = [x.to("cpu", copy=True) for x in model.leaves(params)]
        opt = adamw.init(params)
        step = make_train_step(cfg, lm_tcfg(plan), device=dev, mesh=mesh,
                               mode=mode)
        mets, ms, profile = [], [], None
        steps = data[:MESH_LM_STEPS[mode]]
        with collectives.tally(by="group") as counts:
            for i, b in enumerate(steps):
                dist.barrier()
                if me == 0 and i == len(steps) - 1 \
                        and mode == "megatron":
                    (params, opt, m), profile = mesh_profile(
                        lambda: step(params, opt, b))
                    ms.append(profile["wall_ms"])
                else:
                    (params, opt, m), t_ = synced_ms(
                        lambda: step(params, opt, b))
                    ms.append(t_)
                mets.append({k: float(m[k]) for k in ("loss",
                                                      "grad_norm")})
        wrong = []
        for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
            for x, f, sp in zip(model.leaves(tree),
                                model.leaves(model.param_shapes(cfg)),
                                model.leaves(specs)):
                if tuple(x.shape) != sharding.local_shape(f.shape, sp,
                                                          mesh):
                    wrong.append(name)
        rec = {"metrics": mets, "step_ms": ms, "profile": profile,
               "wrong_shapes": wrong, "tally": step_tally(counts,
                                                          len(steps)),
               "model_group": tuple(dist.get_process_group_ranks(
                   mesh.get_group("model"))),
               "resident_bytes": tree_bytes(params, opt.m, opt.v),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        path = Path(root) / f"{mode}.pt"
        wait_for(path, "17b")           # the one-card side writes it
        want = torch.load(path, map_location=dev)
        rec["params_err"] = sums_update_err(leaf_sums(
            model.leaves(params), want, init, specs, mesh))
        del params, opt, want, init
        torch.cuda.empty_cache()
        out["modes"][mode] = rec
    c = mesh.get_local_rank("data")
    push = sync.make_sync_fns(mesh, sync.SyncConfig(filter=sync_spec))
    synced, _ = push(sync_residual(cfg, c, dev), (MESH_SYNC_KEY, 17, c))
    out["sync"] = {n: sha(x) for n, x in synced.items()}
    del synced
    torch.cuda.empty_cache()
    out["seconds"]["17b"] = time.perf_counter() - t

    def timed(name, fn):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.empty_cache()
        out["seconds"][name] = time.perf_counter() - t0
        return got

    out["serve"] = timed("18b", lambda: serve_mesh_rank(mesh, dev,
                                                        SERVE_GLOO))
    out["serve_ssm"] = timed("18d", lambda: [serve_ssm_rank(mesh, dev, p)
                                             for p in SERVE_SSM])
    wait_for(Path(root) / PHASE16_DONE, "17d")
    out["ssm"] = timed("17d", lambda: [mesh_ssm_rank(mesh, dev, p, root)
                                       for p in SSM_CHECKS])
    wait_for(Path(root) / MAIN_IDLE, "17c")
    out["moe"] = timed("17c", lambda: mesh_moe_rank(mesh, dev))
    return out


def wait_for(path: Path, what: str) -> None:
    """Wait for the smoke's process to write ``path`` (at most
    MESH_TIMEOUT_S)."""
    waited = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - waited > MESH_TIMEOUT_S:
            raise TimeoutError(f"{what}: no {path}")
        time.sleep(0.1)


def sync_residual(cfg, c: int, dev) -> dict:
    """Client c's residual for 17b's push: normal draws of the embedding's
    and the final norm's shapes, from the stream (17, c) on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1700 + c)
    return {"embed": torch.randn((cfg.padded_vocab, cfg.d_model),
                                 generator=gen, device=dev),
            "final_norm": torch.randn((cfg.d_model,), generator=gen,
                                      device=dev)}


def mesh_lm_start(dev, root: Path) -> dict:
    """Start phase 17's four ranks (``mesh_lm_rank``) in a thread of this
    process, before phase 16 (see PHASE16_DONE)."""
    import threading

    from repro_torch.core import ps
    from repro_torch.launch.mesh import run_on_mesh

    root.mkdir(parents=True, exist_ok=True)
    for name in (PHASE16_DONE, MAIN_IDLE):
        (root / name).unlink(missing_ok=True)
    box: dict = {"spec": ps.FilterSpec("topk", **TOPK),
                 "t0": time.perf_counter()}

    def ranks_run():
        try:
            box["ranks"] = run_on_mesh(
                mesh_lm_rank, 2, 2, device=dev, backend="gloo",
                args=(MESH_LM, str(root), box["spec"]),
                timeout=MESH_TIMEOUT_S + 300)
        except BaseException as e:      # re-raised by mesh_lm_gloo
            box["error"] = e

    # 17c's four ranks of ~13 GiB each share the card after 17b's: their
    # allocators grow segments rather than cache fixed ones (set before
    # they start).
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        box["thread"] = threading.Thread(target=ranks_run)
        box["thread"].start()
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    return box


def mesh_lm_gloo(dev, root: Path, card: str, box: dict,
                 one: dict) -> dict:
    """17b, 17c and 17d (see the module docstring): the one-process side
    of 17c, the one-card side of 17d and the sync push's want, then
    ``MAIN_IDLE`` for the ranks that :func:`mesh_lm_start` started
    (``box``), their results against the one-card runs (``one``: 17b's)."""
    import shutil

    from repro_torch.train import sync

    t = time.perf_counter()
    moe_one = moe_one_process(dev)
    phase("mesh-lm 17c one process (beside the ranks)", t)
    t = time.perf_counter()
    ssm_one = [ssm_one_card(dev, p, root) for p in SSM_CHECKS]
    phase("mesh-lm 17d one card (beside the ranks)", t)
    cfg = lm_mesh_config(MESH_LM)
    spec = box["spec"]
    sent = [sync.filter_tree(sync_residual(cfg, c, dev), spec,
                             (MESH_SYNC_KEY, 17, c)) for c in range(2)]
    want_sync = {n: sha(sent[0][n] + sent[1][n]) for n in sent[0]}
    kept = int(sent[0]["embed"].ne(0).any(1).sum())
    del sent
    torch.cuda.empty_cache()
    (root / MAIN_IDLE).write_text("")
    t = time.perf_counter()
    box["thread"].join()
    phase("mesh-lm the ranks' rest (17d's, 17c)", t)
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    box["moe_steps"] = moe_seq_steps_start(dev)
    launched_s = time.perf_counter() - box["t0"]
    shutil.rmtree(root, ignore_errors=True)
    tokens = MESH_LM["batch"] * MESH_LM["seq"]
    summary = {}
    for mode in MESH_LM_MODES:
        recs = [r["modes"][mode] for r in ranks]
        want = one[mode]
        bounds = {k: max(MESH_LM_MARGIN * want["spread"][k],
                         MESH_LM_FLOOR[k]) for k in MESH_LM_FLOOR}
        err = {k: max(abs(g[k] - w[k]) / abs(w[k]) for g, w in
                      zip(recs[0]["metrics"], want["metrics"]))
               for k in ("loss", "grad_norm")}
        err["params"] = recs[0]["params_err"]
        for r, rec in enumerate(recs):
            if rec["metrics"] != recs[0]["metrics"]:
                raise AssertionError(f"17b {mode}: rank {r}'s metrics "
                                     "differ from rank 0's")
            if rec["wrong_shapes"]:
                raise AssertionError(f"17b {mode}: rank {r}'s blocks "
                                     f"{rec['wrong_shapes']} off their specs")
        bad = {k: (err[k], bounds[k]) for k in err if err[k] > bounds[k]}
        step_ms = statistics.median(recs[0]["step_ms"][1:]
                                    or recs[0]["step_ms"])
        summary[mode] = {
            "losses": [m["loss"] for m in recs[0]["metrics"]],
            "one_card_losses": [m["loss"] for m in want["metrics"]],
            "err": err, "spread": want["spread"], "bounds": bounds,
            "step_ms_rank0": recs[0]["step_ms"], "step_ms": step_ms,
            "one_card_step_ms": statistics.median(want["step_ms"][1:]
                                                  or want["step_ms"]),
            "tokens_per_s": tokens / (step_ms / 1e3),
            "resident_bytes_by_rank": [r["resident_bytes"] for r in recs],
            "one_card_bytes": want["one_card_bytes"],
            "peak_gib_by_rank": [r["peak_gib"] for r in recs],
            "profiled_step_ms": recs[0]["profile"]["wall_ms"]
            if recs[0]["profile"] else None, "card": card,
            "beside": BESIDE["17b"]}
        n = MESH_LM_STEPS[mode]
        which = f"median of steps 2-{n}" if n > 1 else "its one step"
        print(f"MESH-LM 17b {mode}: step {step_ms:.1f} ms (rank 0, {which}"
              + (", the last profiled" if recs[0]["profile"] else "")
              + "; one card "
              f"{summary[mode]['one_card_step_ms']:.1f} ms), "
              f"{summary[mode]['tokens_per_s']:.0f} tokens/s; loss "
              f"{err['loss']:.2e} (bound {bounds['loss']:.2e}), grad_norm "
              f"{err['grad_norm']:.2e} (bound {bounds['grad_norm']:.2e}), "
              f"params {err['params']:.2e} (bound {bounds['params']:.2e}) "
              "against one card; resident "
              f"{max(summary[mode]['resident_bytes_by_rank']) / 2**30:.3f}"
              f" GiB a rank against {want['one_card_bytes'] / 2**30:.3f} "
              f"on one card; peak "
              f"{max(summary[mode]['peak_gib_by_rank']):.2f} GiB a rank "
              f"on {card}; {BESIDE['17b']}", flush=True)
        if recs[0]["profile"]:          # megatron's last step
            summary[mode]["collectives"] = collective_totals(
                f"17b {mode}", recs[0]["profile"], 4)
        summary[mode]["tally"] = tally_lines(
            f"MESH-LM 17b {mode}", recs[0]["tally"], recs[0]["model_group"],
            "step")
        if mode == "megatron" and summary[mode]["tally"]["model_weight_gathers"]:
            raise AssertionError("17b megatron: weights gathered over the "
                                 "model group: " + str(
                                     summary[mode]["tally"]))
        print(f"MESH-LM 17b {mode} {json.dumps(summary[mode])}", flush=True)
        if bad:
            raise AssertionError(f"17b {mode}: {bad} beyond the bounds")
    for r in ranks:
        if r["sync"] != want_sync:
            raise AssertionError(f"17b: make_sync_fns' push on rank "
                                 f"{r['rank']} differs from the sum of the "
                                 "clients' filter_tree")
    summary["sync"] = {"rows_kept_client0": kept, "equal": True}
    print(f"MESH-LM 17b make_sync_fns top-k push ({TOPK['k_rows']} + "
          f"{TOPK['random_rows']} rows; client 0 kept {kept} of "
          f"{cfg.padded_vocab}) equal to the one-process sum on all four "
          f"ranks; run_on_mesh (17b, 17c, 17d, 18b and 18d) "
          f"{launched_s:.1f} s; rank 0's parts "
          f"{json.dumps(ranks[0]['seconds'])} s",
          flush=True)
    summary["17c"] = moe_check(moe_one, [r["moe"] for r in ranks], card)
    summary["17d"] = [ssm_check(p, one_, [r["ssm"][i] for r in ranks], card)
                      for i, (p, one_) in enumerate(zip(SSM_CHECKS,
                                                        ssm_one))]
    return summary, {"18b": [r["serve"] for r in ranks],
                     "18d": [r["serve_ssm"] for r in ranks]}


def moe_block_inputs(cfg, dev):
    """17c's tokens: (batch, seq, d) bf16 normal draws from stream 1717."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1717)
    return torch.randn((MESH_MOE["batch"], MESH_MOE["seq"], cfg.d_model),
                       generator=gen, device=dev).to(torch.bfloat16)


def mesh_moe_rank(mesh, dev) -> dict:
    """17c on one rank: the MoE block of layer 0 on the rank's row of the
    tokens with its E/m experts, profiled (the all-to-all spans), then one
    zero_batch train step."""
    import torch.distributed as dist

    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import layers, model, moe
    from repro_torch.optim import adamw
    from repro_torch.train import sharding
    from repro_torch.train.train_step import make_train_step, param_layout

    me = dist.get_rank()
    cfg = lm_mesh_config(MESH_MOE)
    full = model.init_params(cfg, seed=0, device=dev)
    x = moe_block_inputs(cfg, dev)[me:me + 1]
    m, e = mesh.get_local_rank("model"), cfg.n_experts
    half = slice(m * e // 2, (m + 1) * e // 2)
    p = {k: v[0] if k == "router" else v[0, half]
         for k, v in full["blocks"]["moe"].items()}
    act = sharding.activation_spec(sharding.axis_sizes(mesh), "zero_batch")
    with torch.no_grad(), layers.mesh_hooks(act, None, mesh):
        taken = moe.a2a_applies(cfg, x.shape[0] * x.shape[1] * 4)
        (out, aux), prof = mesh_profile(lambda: moe.moe_block(cfg, p, x))
    del p
    specs = param_layout(cfg, mesh, "zero_batch")
    params = sharding.shard_tree(full, specs, mesh)
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw.init(params)
    batch = next(lm_batches(cfg.vocab_size, MESH_MOE["batch"],
                            MESH_MOE["seq"], 1, seed=3, kind="affine"))
    step = make_train_step(cfg, lm_tcfg({**MESH_MOE, "peak_lr": 1e-4,
                                         "steps": 1}),
                           device=dev, mesh=mesh, mode="zero_batch")
    dist.barrier()
    (_, _, met), t_ = synced_ms(lambda: step(params, opt, batch))
    out = {"taken": taken, "out": out.cpu(), "aux": float(aux),
           "block_profile": prof, "loss": float(met["loss"]),
           "grad_norm": float(met["grad_norm"]), "step_ms": t_,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del params, opt, step
    torch.cuda.empty_cache()
    out["seq"] = mesh_moe_seq_rank(mesh, dev, cfg)
    return out


def mesh_moe_seq_rank(mesh, dev, cfg) -> dict:
    """17c's zero_seq block on one rank of the four: the MoE block of layer
    0 on the rank's rows and positions of the tokens, its collectives
    tallied by name."""
    from repro_torch.core import collectives
    from repro_torch.models import layers, model, moe
    from repro_torch.train import sharding

    full = model.init_params(cfg, seed=0, device=dev)
    # the experts in bf16 (their values at use), the router as it is
    p = {k: v[0] if k == "router" else v[0].to(torch.bfloat16)
         for k, v in full["blocks"]["moe"].items()}
    del full
    x = sharding.local_shard(moe_block_inputs(cfg, dev),
                             sharding.P("data", "model"), mesh)
    act = sharding.activation_spec(sharding.axis_sizes(mesh), "zero_seq")
    with torch.no_grad(), layers.mesh_hooks(act, None, mesh), \
            collectives.tally(by="what") as counts:
        placed = layers.seq_groups(x.shape[0], x.shape[1],
                                   MESH_MOE["seq"]) is not None
        (out, aux), ms = synced_ms(lambda: moe.moe_block(cfg, p, x))
    return {"placed": placed, "out": out.cpu(), "aux": float(aux),
            "coords": {a: mesh.get_local_rank(a)
                       for a in mesh.mesh_dim_names},
            "block_ms": ms, "block_tally": counts}


def moe_seq_step_rank(mesh, dev) -> dict:
    """17c's zero_seq train step on one rank of MOE_SEQ_STEP_MESH (its
    collectives tallied by name, its peak)."""
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import layers, model
    from repro_torch.optim import adamw
    from repro_torch.train import sharding
    from repro_torch.train.train_step import make_train_step, param_layout

    cfg = lm_mesh_config(MESH_MOE)
    specs = param_layout(cfg, mesh, "zero_seq")
    params = sharding.shard_tree(model.init_params(cfg, seed=0, device=dev),
                                 specs, mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw.init(params)
    batch = next(lm_batches(cfg.vocab_size, MESH_MOE["batch"],
                            MESH_MOE["seq"], 1, seed=3, kind="affine"))
    rows = MESH_MOE["batch"] // sharding.axis_sizes(mesh)["data"]
    seq = MESH_MOE["seq"] // sharding.axis_sizes(mesh)["model"]
    with layers.mesh_hooks(sharding.activation_spec(
            sharding.axis_sizes(mesh), "zero_seq"), None, mesh):
        placed = layers.seq_groups(rows, seq, MESH_MOE["seq"]) is not None
    step = make_train_step(cfg, lm_tcfg({**MESH_MOE, "peak_lr": 1e-4,
                                         "steps": 1}),
                           device=dev, mesh=mesh, mode="zero_seq")
    dist.barrier()
    with collectives.tally(by="what") as counts:
        (_, _, met), t_ = synced_ms(lambda: step(params, opt, batch))
    return {"placed": placed, "tally": counts, "loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"]), "step_ms": t_,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def moe_seq_steps_start(dev) -> dict:
    """Start 17c's zero_seq train step on MOE_SEQ_STEP_MESH, gloo on the
    card, in a thread of this process (once the four ranks have exited:
    see MOE_SEQ_STEP_MESH); it runs beside phase 18's one-card sides and
    :func:`moe_seq_step_check` waits for it."""
    import threading

    from repro_torch.launch.mesh import run_on_mesh

    sbox: dict = {"t0": time.perf_counter()}

    def steps_run():
        try:
            sbox["ranks"] = run_on_mesh(
                moe_seq_step_rank, *MOE_SEQ_STEP_MESH, device=dev,
                backend="gloo", timeout=MESH_TIMEOUT_S)
        except BaseException as e:      # re-raised by moe_seq_step_check
            sbox["error"] = e
        sbox["seconds"] = time.perf_counter() - sbox["t0"]

    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        sbox["thread"] = threading.Thread(target=steps_run)
        sbox["thread"].start()
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    return sbox


def moe_one_process(dev) -> dict:
    """17c's one-process side, run first and freed: the grouped dispatch
    of layer 0's MoE block on all the tokens."""
    from repro_torch.models import model, moe

    cfg = lm_mesh_config(MESH_MOE)
    params = model.init_params(cfg, seed=0, device=dev)
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = moe_block_inputs(cfg, dev)
    with torch.no_grad():
        (want, aux), ms = synced_ms(lambda: moe.moe_block(cfg, p, x))
    out = {"out": want.cpu(), "aux": float(aux), "ms": ms}
    del params, p, x, want
    torch.cuda.empty_cache()
    return out


def moe_check(one: dict, ranks: list, card: str) -> dict:
    """17c (see the module docstring): the ranks' a2a block against the
    one-process dispatch, the all-to-all spans, the train step."""
    cfg = lm_mesh_config(MESH_MOE)
    got = torch.cat([r["out"] for r in ranks])
    want = one["out"]
    gap = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    spans = sorted({c["what"] + " " + c["op"] for r in ranks
                    for c in r["block_profile"]["collectives"]})
    summary = {"a2a_taken": [r["taken"] for r in ranks],
               "block_spans": spans, "max_rel_diff": gap,
               "bit_equal": bool(torch.equal(got, want)),
               "aux": [r["aux"] for r in ranks],
               "one_process_aux": one["aux"],
               "one_process_block_ms": one["ms"],
               "block_ms_rank0": ranks[0]["block_profile"]["wall_ms"],
               "step": {"loss": ranks[0]["loss"],
                        "grad_norm": ranks[0]["grad_norm"],
                        "ms_by_rank": [r["step_ms"] for r in ranks]},
               "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
               "card": card}
    print(f"MESH-LM 17c {cfg.name} (d {cfg.d_model}, {cfg.n_experts} "
          f"experts, d_ff {cfg.d_ff}, 1 layer, zero_batch, moe_groups 4): "
          f"_moe_a2a taken on every rank {all(summary['a2a_taken'])}, "
          f"spans {spans}; block against one process: bit-equal "
          f"{summary['bit_equal']}, max |diff| / max {gap:.2e} (bound "
          f"{MESH_MOE_TOL:.2e}); train step loss {ranks[0]['loss']:.4f} "
          f"grad_norm {ranks[0]['grad_norm']:.3f} "
          f"{ranks[0]['step_ms']:.1f} ms; peak "
          f"{max(summary['peak_gib_by_rank']):.2f} GiB a rank on {card}",
          flush=True)
    summary["block_collectives"] = collective_totals(
        "17c moe block", ranks[0]["block_profile"], 4)
    print(f"MESH-LM 17c {json.dumps(summary)}", flush=True)
    if not all(summary["a2a_taken"]) or not any(
            s_.startswith("moe dispatch all_to_all") for s_ in spans):
        raise AssertionError(f"17c: the a2a path was not taken: {spans}")
    if gap > MESH_MOE_TOL:
        raise AssertionError(f"17c: a2a block {gap} from one process")
    if not (np.isfinite(ranks[0]["loss"]) and np.isfinite(
            ranks[0]["grad_norm"])):
        raise AssertionError(f"17c: train step {ranks[0]}")
    summary["zero_seq"] = moe_seq_check(one, [r["seq"] for r in ranks],
                                        card)
    return summary


def moe_seq_check(one: dict, ranks: list, card: str) -> dict:
    """17c's zero_seq block: the four ranks' blocks put together against
    the one-process grouped dispatch (the same groups: a row each), no
    token-group gather on any rank."""
    cfg = lm_mesh_config(MESH_MOE)
    rows, seq = MESH_MOE["batch"], MESH_MOE["seq"]
    got = torch.empty((rows, seq, cfg.d_model), dtype=one["out"].dtype)
    for r in ranks:
        d, m = r["coords"]["data"], r["coords"]["model"]
        got[d * rows // 2:(d + 1) * rows // 2,
            m * seq // 2:(m + 1) * seq // 2] = r["out"]
    want = one["out"]
    gap = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    gathered = sorted({k for r in ranks for k in r["block_tally"]}
                      & set(MOE_GATHERS))
    summary = {"placed_on_every_rank": all(r["placed"] for r in ranks),
               "max_rel_diff": gap, "bit_equal": bool(torch.equal(got, want)),
               "aux": [r["aux"] for r in ranks],
               "one_process_aux": one["aux"],
               "block_ms_by_rank": [r["block_ms"] for r in ranks],
               "block_bytes_rank0": {k: c["bytes"] for k, c in
                                     ranks[0]["block_tally"].items()},
               "token_gathers": gathered, "card": card}
    print(f"MESH-LM 17c zero_seq {cfg.name} (a group a row, "
          f"moe_groups {MESH_MOE['moe_groups']}): the 2x2 block against "
          f"one process: bit-equal {summary['bit_equal']}, max |diff| / max "
          f"{gap:.2e} (bound {MESH_MOE_TOL:.2e}); rank 0's exchanges "
          + ", ".join(f"{k} {v} B" for k, v in
                      summary["block_bytes_rank0"].items())
          + f"; token-group gathers: {gathered or 'none'}", flush=True)
    print(f"MESH-LM 17c zero_seq {json.dumps(summary)}", flush=True)
    if not summary["placed_on_every_rank"] or gathered:
        raise AssertionError(f"17c zero_seq: groups not rank-local: "
                             f"{summary}")
    if gap > MESH_MOE_TOL:
        raise AssertionError(f"17c zero_seq: block {gap} from one process")
    return summary


def moe_seq_step_check(sbox: dict, card: str) -> dict:
    """17c's zero_seq train step (:func:`moe_seq_steps_start`), once it
    has ended: its ``moe seq`` exchanges on rank 0 against
    MOE_SEQ_PREDICTED (equal to the byte), no token-group gather on any
    rank, the loss finite, the peak a rank beside the tool's."""
    sbox["thread"].join()
    if "error" in sbox:
        raise sbox["error"]
    steps = sbox["ranks"]
    mine = {k: steps[0]["tally"].get(k, {"bytes": 0})["bytes"]
            for k in MOE_SEQ_PREDICTED}
    gathered = sorted({k for r in steps for k in r["tally"]}
                      & set(MOE_GATHERS))
    peak = max(r["peak_gib"] for r in steps)
    summary = {"placed_on_every_rank": all(r["placed"] for r in steps),
               "step_mesh": MOE_SEQ_STEP_MESH,
               "step_bytes_rank0": mine, "predicted": MOE_SEQ_PREDICTED,
               "token_gathers": gathered,
               "step": {"loss": steps[0]["loss"],
                        "grad_norm": steps[0]["grad_norm"],
                        "ms_by_rank": [r["step_ms"] for r in steps]},
               "step_bytes_in_rank0": sum(
                   c["bytes"] for c in steps[0]["tally"].values()),
               "peak_gib_by_rank": [r["peak_gib"] for r in steps],
               "peak_gib_predicted": MOE_SEQ_PEAK_PREDICTED_GIB,
               "seconds": sbox["seconds"], "beside": BESIDE["17c step"],
               "card": card}
    print(f"MESH-LM 17c zero_seq train step on "
          f"{MOE_SEQ_STEP_MESH[0]}x{MOE_SEQ_STEP_MESH[1]}: exchanges on "
          "rank 0: " + ", ".join(f"{k[11:]} {v} B (predicted "
                                 f"{MOE_SEQ_PREDICTED[k]})"
                                 for k, v in mine.items())
          + f"; token-group gathers: {gathered or 'none'}; loss "
          f"{steps[0]['loss']:.4f} grad_norm {steps[0]['grad_norm']:.3f} "
          f"{steps[0]['step_ms']:.1f} ms; peak {peak:.2f} GiB a rank on "
          f"{card} (the tool's MemTracker {MOE_SEQ_PEAK_PREDICTED_GIB:.2f}); "
          f"{sbox['seconds']:.1f} s with its processes' start, beside "
          f"{BESIDE['17c step']}", flush=True)
    print(f"MESH-LM 17c zero_seq step {json.dumps(summary)}", flush=True)
    if not summary["placed_on_every_rank"] or gathered:
        raise AssertionError(f"17c zero_seq step: groups not rank-local: "
                             f"{summary}")
    if mine != MOE_SEQ_PREDICTED:
        raise AssertionError(f"17c zero_seq step: exchanges {mine}, "
                             f"predicted {MOE_SEQ_PREDICTED}")
    if not (np.isfinite(steps[0]["loss"]) and np.isfinite(
            steps[0]["grad_norm"])):
        raise AssertionError(f"17c zero_seq step: {steps[0]}")
    return summary


def leaf_sums(mine: list, want: list, base: list | None, specs,
              mesh) -> torch.Tensor:
    """(leaves, 2) float64: per leaf ||mine - want||^2 and ||want - base||^2
    (``base`` None: ||want||^2), each rank its blocks (``mine``, ``base``)
    against its blocks of the whole leaves ``want``, summed over the ranks.
    Each element of a leaf is held by as many ranks as every other, so
    ratios of these sums are the whole leaves' (nothing is gathered)."""
    import torch.distributed as dist

    from repro_torch.models import model
    from repro_torch.train import sharding

    want = model.leaves(sharding.shard_tree(model.unflatten(specs, want),
                                            specs, mesh))
    sq = lambda a, b: float((a.double() - b.to(a.device).double())
                            .square().sum())
    sums = torch.tensor(
        [[sq(x, w), sq(w, b) if b is not None
          else float(w.double().square().sum())]
         for x, w, b in zip(mine, want, base or [None] * len(mine))],
        dtype=torch.float64)
    dist.all_reduce(sums)
    return sums


def sums_update_err(sums: torch.Tensor) -> float:
    """:func:`update_err` from :func:`leaf_sums`' rows."""
    return max((float((a / b).sqrt()) for a, b in sums if b > 0),
               default=0.0)


def ssm_name(plan: dict) -> str:
    """17d's name of a plan: its arch, its compute dtype if not bf16 and
    its mode if not megatron."""
    return plan["arch"] + (" float32" if plan.get("float32") else "") + (
        "" if plan_mode(plan) == "megatron" else " " + plan_mode(plan))


@contextlib.contextmanager
def plan_dtype(plan: dict):
    """The LM's compute dtype float32 inside, where ``plan`` asks for it."""
    from repro_torch.models import layers
    saved = layers.COMPUTE_DTYPE
    if plan.get("float32"):
        layers.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = saved


def leaf_names(tree: dict, pre: str = "") -> list:
    """The paths of ``tree``'s leaves in ``model.leaves``' order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaf_names(v, f"{pre}{k}/") if isinstance(v, dict)
                   else [pre + k])
    return out


def leaf_errs(got: list, want: list) -> list:
    """||got - want|| / ||want|| leaf by leaf (0 where both are 0)."""
    return [float((g.float() - w.float()).norm()
                  / w.float().norm().clamp_min(1e-30))
            for g, w in zip(got, want)]


def ssm_one_card(dev, plan: dict, root: Path) -> dict:
    """17d's one-card side, run alone before the ranks start and freed:
    the step(s) of ``plan`` from the seed's weights with one and two
    microbatches (the one-card run's own spread: the loss, grad_norm and
    parameters as 17b's, and AdamW's m after the step leaf by leaf), their
    metrics, step ms, resident bytes and peak; the one-microbatch run's
    final parameters and m saved under ``root`` for rank 0.  A zero mode's
    plan runs under its activation spec."""
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = lm_mesh_config(plan)
    data = plan_batches(cfg, plan)
    runs = {}
    for mb in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = model.init_params(cfg, seed=0, device=dev)
        opt = adamw.init(params)
        mets, ms = [], []
        with plan_dtype(plan), plan_hooks(plan):
            step = make_train_step(cfg, lm_tcfg(plan, mb), device=dev)
            for b in data:
                (params, opt, m), t_ = synced_ms(lambda: step(params, opt,
                                                              b))
                mets.append({k: float(m[k]) for k in ("loss",
                                                      "grad_norm")})
                ms.append(t_)
        runs[mb] = (mets, model.leaves(params), ms,
                    torch.cuda.max_memory_allocated() / 2**30,
                    tree_bytes(params, opt.m, opt.v), model.leaves(opt.m))
        del params, opt
        torch.cuda.empty_cache()
    init = model.leaves(model.init_params(cfg, seed=0, device=dev))
    mets1, final1, ms1, peak1, bytes1, m1 = runs[1]
    spread = {k: max(abs(runs[2][0][s_][k] - mets1[s_][k])
                     / abs(mets1[s_][k]) for s_ in range(len(data)))
              for k in ("loss", "grad_norm")}
    spread["params"] = update_err(runs[2][1], final1, init)
    names = leaf_names(model.param_shapes(cfg))
    by_leaf = {"grads": leaf_errs(runs[2][5], m1),
               "params": [update_err([a], [b], [c]) for a, b, c in
                          zip(runs[2][1], final1, init)]}
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"17d-{ssm_name(plan).replace(' ', '-')}.pt"
    tmp = path.with_suffix(".pt.tmp")
    torch.save({"params": [x.cpu() for x in final1],
                "m": [x.cpu() for x in m1]}, tmp)
    tmp.rename(path)
    del runs, final1, init, m1
    torch.cuda.empty_cache()
    return {"metrics": mets1, "spread": spread, "step_ms": ms1,
            "peak_gib": peak1, "one_card_bytes": bytes1, "names": names,
            "spread_by_leaf": by_leaf}


def mesh_ssm_rank(mesh, dev, plan: dict, root: str) -> dict:
    """17d on one rank of the 2x2 gloo mesh: the step(s) of ``plan`` in
    its mode from the seed's weights cut to the rank's blocks; its
    metrics, step ms, blocks' shapes against their specs, resident bytes,
    peak memory and collectives by name and group; the parameters and
    AdamW's m against the one-card run's, each rank its blocks against
    theirs and the leaves' sums of squares summed over the ranks (the
    leaves are not gathered: a leaf's elements are each held by as many
    ranks, so the ratios are the whole leaves')."""
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import sharding
    from repro_torch.train.train_step import make_train_step, param_layout

    cfg = lm_mesh_config(plan)
    data = plan_batches(cfg, plan)
    specs = param_layout(cfg, mesh, plan_mode(plan))
    params = sharding.shard_tree(model.init_params(cfg, seed=0, device=dev),
                                 specs, mesh)
    opt = adamw.init(params)
    torch.cuda.synchronize()
    gc.collect()            # an earlier plan's cycles, so its tensors free
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mets, ms = [], []
    with plan_dtype(plan), collectives.tally(by="group") as counts:
        step = make_train_step(cfg, lm_tcfg(plan), device=dev, mesh=mesh,
                               mode=plan_mode(plan))
        for b in data:
            dist.barrier()
            (params, opt, m), t_ = synced_ms(lambda: step(params, opt, b))
            mets.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            ms.append(t_)
    peak = torch.cuda.max_memory_allocated() / 2**30
    wrong = [name for name, tree in (("params", params), ("m", opt.m),
                                     ("v", opt.v))
             for x, f, sp in zip(model.leaves(tree),
                                 model.leaves(model.param_shapes(cfg)),
                                 model.leaves(specs))
             if tuple(x.shape) != sharding.local_shape(f.shape, sp, mesh)]
    rec = {"metrics": mets, "step_ms": ms, "wrong_shapes": wrong,
           "tally": step_tally(counts, len(data)), "peak_gib": peak,
           "resident_bytes": tree_bytes(params, opt.m, opt.v),
           "model_group": tuple(dist.get_process_group_ranks(
               mesh.get_group("model")))}
    path = Path(root) / f"17d-{ssm_name(plan).replace(' ', '-')}.pt"
    wait_for(path, "17d")               # the one-card side writes it
    want = torch.load(path, map_location=dev)
    init = model.leaves(sharding.shard_tree(
        model.init_params(cfg, seed=0, device=dev), specs, mesh))
    rec["params_err"] = sums_update_err(leaf_sums(
        model.leaves(params), want["params"], init, specs, mesh))
    rec["grads_err"] = [float((a / b.clamp_min(1e-60)).sqrt()) for a, b in
                        leaf_sums(model.leaves(opt.m), want["m"], None,
                                  specs, mesh)]
    del want, init, params, opt
    torch.cuda.empty_cache()
    return rec


def ssm_check(plan: dict, one: dict, recs: list, card: str) -> dict:
    """17d (see the module docstring): the ranks' step against one card's,
    by 17b's bounds, and its first gradients leaf by leaf (SSM_GRAD_FLOOR,
    SSM_GRAD_HELD; every leaf where ``plan`` says ``hold_all``); MESH-LM
    lines."""
    cfg, name = lm_mesh_config(plan), ssm_name(plan)
    bounds = {k: max(MESH_LM_MARGIN * one["spread"][k], MESH_LM_FLOOR[k])
              for k in MESH_LM_FLOOR}
    names, spreads = one["names"], one["spread_by_leaf"]
    grads = {n: {"err": e, "spread": sp,
                 "bound": max(MESH_LM_MARGIN * sp,
                              plan.get("grad_floor", SSM_GRAD_FLOOR))}
             for n, e, sp in zip(names, recs[0]["grads_err"],
                                 spreads["grads"])}
    held = {n: g for n, g in grads.items() if g["bound"] < SSM_GRAD_HELD}
    loose = sorted(set(grads) - set(held))
    widest = sorted(zip(spreads["params"], names), reverse=True)[:3]
    err = {k: max(abs(g[k] - w[k]) / abs(w[k]) for g, w in
                  zip(recs[0]["metrics"], one["metrics"]))
           for k in ("loss", "grad_norm")}
    err["params"] = recs[0]["params_err"]
    for r, rec in enumerate(recs):
        if rec["metrics"] != recs[0]["metrics"]:
            raise AssertionError(f"17d {name}: rank {r}'s metrics "
                                 "differ from rank 0's")
        if rec["wrong_shapes"]:
            raise AssertionError(f"17d {name}: rank {r}'s blocks "
                                 f"{rec['wrong_shapes']} off their specs")
    label = f"MESH-LM 17d {name}"
    summary = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "compute": "float32" if plan.get("float32") else "bfloat16",
               "batch": plan["batch"], "seq": plan["seq"],
               "losses": [m["loss"] for m in recs[0]["metrics"]],
               "one_card_losses": [m["loss"] for m in one["metrics"]],
               "err": err, "spread": one["spread"], "bounds": bounds,
               "step_ms_by_rank": [r["step_ms"] for r in recs],
               "one_card_step_ms": one["step_ms"],
               "resident_bytes_by_rank": [r["resident_bytes"] for r in recs],
               "one_card_bytes": one["one_card_bytes"],
               "peak_gib_by_rank": [r["peak_gib"] for r in recs],
               "one_card_peak_gib": one["peak_gib"], "card": card,
               "grads_by_leaf": grads, "grads_not_held": loose,
               "beside": BESIDE["17d"],
               "params_spread_widest": [[n, x] for x, n in widest]}
    mamba = {n: g["spread"] for n, g in grads.items() if "/mamba/" in n}
    if mamba and not plan.get("float32"):
        print(f"{label} one card's own spread of the Mamba-2 leaves' first "
              "gradients between 1 and 2 microbatches: "
              + ", ".join(f"{n} {x:.3g}" for n, x in sorted(mamba.items()))
              + "; held: "
              + (", ".join(n for n in sorted(mamba) if n in held) or "none"),
              flush=True)
        summary["mamba_spread"] = mamba
    worst = max(held, key=lambda n: held[n]["err"] / held[n]["bound"],
                default=None)
    print(f"{label} first gradients (AdamW's m) against one card's: "
          f"{len(held)} of {len(grads)} leaves held, worst "
          + (f"{worst} {held[worst]['err']:.2e} (bound "
             f"{held[worst]['bound']:.2e})" if worst else "none")
          + f"; not held (one card's own spread x {MESH_LM_MARGIN:g} "
          f">= {SSM_GRAD_HELD}): "
          + (", ".join(f"{n} {grads[n]['err']:.2e} (spread "
                       f"{grads[n]['spread']:.2e})" for n in loose)
             or "none")
          + "; the widest spread of the update between 1 and 2 "
          "microbatches: " + ", ".join(f"{n} {x:.2e}" for x, n in widest),
          flush=True)
    print(f"{label} ({cfg.n_layers} layers, {plan['batch']}x{plan['seq']}, "
          f"{plan_mode(plan)}, 2x2 gloo): step {recs[0]['step_ms'][-1]:.1f} ms "
          f"(rank 0; one card {one['step_ms'][-1]:.1f}); loss "
          f"{err['loss']:.2e} (bound {bounds['loss']:.2e}), grad_norm "
          f"{err['grad_norm']:.2e} (bound {bounds['grad_norm']:.2e}), "
          f"params {err['params']:.2e} (bound {bounds['params']:.2e}) "
          f"against one card; resident "
          f"{max(summary['resident_bytes_by_rank']) / 2**30:.3f} GiB a rank "
          f"against {one['one_card_bytes'] / 2**30:.3f} on one card; peak "
          f"{max(summary['peak_gib_by_rank']):.2f} GiB a rank against "
          f"{one['peak_gib']:.2f} on one card on {card}; "
          f"{BESIDE['17d']}", flush=True)
    summary["tally"] = tally_lines(label, recs[0]["tally"],
                                   recs[0]["model_group"], "step")
    if plan_mode(plan) == "zero_seq":
        summary["exchanges"] = seq_exchanges(label, name, recs, one)
    print(f"{label} {json.dumps(summary)}", flush=True)
    if plan_mode(plan) == "megatron" and \
            summary["tally"]["model_weight_gathers"]:
        raise AssertionError(f"17d {name}: weights gathered over the "
                             f"model group: {summary['tally']}")
    bad = {k: (err[k], bounds[k]) for k in err if err[k] > bounds[k]}
    bad.update({f"grad {n}": (g["err"], g["bound"]) for n, g in held.items()
                if not g["err"] <= g["bound"]})
    if plan.get("hold_all") and loose:
        bad["grads not held"] = loose
    if bad:
        raise AssertionError(f"17d {name}: {bad} beyond the bounds")
    return summary


def seq_exchanges(label: str, name: str, recs: list, one: dict) -> dict:
    """A zero_seq step of 17d: its rank-boundary exchanges by name on rank
    0 against SEQ_PREDICTED (equal to the byte), no ``sequence in`` or
    ``frames`` gather on any rank, and the peak GiB a rank against the
    same step's before the change (SEQ_PEAK_BEFORE); a line of each."""
    by_name: dict = {}
    for key, c in recs[0]["tally"].items():
        got = by_name.setdefault(key.rpartition(" @")[0], 0)
        by_name[key.rpartition(" @")[0]] = got + c["bytes"]
    gathered = sorted({k.rpartition(" @")[0] for r in recs
                       for k in r["tally"]} & set(SEQ_GATHERS))
    want = SEQ_PREDICTED[name]
    got = {k: by_name.get(k, 0) for k in want}
    peak = max(r["peak_gib"] for r in recs)
    out = {"bytes": got, "predicted": want, "sequence_gathers": gathered,
           "peak_gib": peak, "peak_gib_before": SEQ_PEAK_BEFORE[name]}
    print(f"{label} rank-boundary exchanges in a step on rank 0: "
          + (", ".join(f"{k} {v} B (predicted {want[k]})"
                       for k, v in got.items()) or "none")
          + f"; sequence gathers: {gathered or 'none'}; peak {peak:.2f} GiB "
          f"a rank (before the change {SEQ_PEAK_BEFORE[name]} GiB on the "
          f"same card; one card {one['peak_gib']:.2f})", flush=True)
    if gathered or got != want:
        raise AssertionError(f"17d {name}: {out}")
    return out


def mesh_lm_phase(dev, state16: dict, root: Path, card: str, box: dict,
                  one: dict) -> dict:
    """Phase 17: 17a, then 17b, 17c and 17d from the four ranks that
    :func:`mesh_lm_start` started before phase 16 (``box``; ``one``: 17b's
    one-card side), which also run 18b's and 18d's ranks
    (``serve_mesh_rank``, ``serve_ssm_rank``; their results under ``"18
    ranks"``); each prints MESH-LM lines."""
    t = time.perf_counter()
    out = {"17a": mesh_lm_world1(dev, state16, card)}
    state16.clear()
    torch.cuda.empty_cache()
    phase("mesh-lm 17a (beside the ranks)", t)
    out["17b"], out["18 ranks"] = mesh_lm_gloo(dev, root, card, box, one)
    return out


# ---------------------------------------------------------------------------
# Phase 18: serving the LM over a mesh, and one dry-run workload
# ---------------------------------------------------------------------------

# 18a: smollm-360m as published, 16a's final state in the serve layout's
# bf16, prefill of 8 x 512 tokens then 16 decode steps.
SERVE_MESH = {"arch": "smollm-360m", "batch": 8, "seq": 512, "decode": 16}
# 18b: the same widths at 17b's depth on a 2x2 gloo mesh of four processes
# on the card: prefill 8 x 512 and 4 decode steps under megatron, one
# prefill under zero_seq.
SERVE_GLOO = {"arch": "smollm-360m", "n_layers": 8, "batch": 8, "seq": 512,
              "decode": 4}
# 18b's decode bytes a step a rank when each layer's weights were gathered
# whole at use (H100, 700 W, before the tensor-parallel products): the
# megatron decode step must now move fewer.
DECODE_BYTES_BEFORE = 346_283_520
# 18d: 17d's two models served: prefill 2 x 512 and 3 decode steps under
# megatron, a cache of 516 (zamba2's shared K/V sequence split over
# ``model``).
SERVE_SSM = tuple({"arch": p["arch"], "n_layers": p["n_layers"],
                   "batch": 2, "seq": 512, "decode": 3, "max_len": 516}
                  for p in MESH_SSM)
# 18d's decode bytes in a step a rank: before the split (the mixers'
# weights and the SSM states gathered at use) and as
# ``tools/torch_mesh_tally.py --kind decode --batch 2 --seq 516`` counts
# them on a fake 2x2 group.
SERVE_SSM_BEFORE = {"rwkv6-3b": 79_939_072, "zamba2-2.7b": 242_857_216}
SERVE_SSM_PREDICTED = {"rwkv6-3b": 193_236, "zamba2-2.7b": 323_320}
# 18c: one workload of the pod dry run, in a process of its own.
SERVE_DRY = ("smollm-360m", "decode_32k")
DRYRUN_TIMEOUT_S = 300


def serve_run(cfg, params, tokens, s: int, n: int, mesh=None,
              mode: str = "megatron", b: int | None = None,
              max_len: int | None = None) -> dict:
    """Prefill of ``tokens[:, :s]`` then ``n`` decode steps fed the next
    tokens (on ``mesh``: the rank's rows of the global batch of ``b``
    rows, in the serve layout, the prefill under ``mode``) into a cache of
    ``max_len`` (by default s + n): each call's logits on the host, the
    final cache, each step's ms closed by a sync, and the decode steps'
    collectives by kind (``collectives.tally``)."""
    from repro_torch.core import collectives
    from repro_torch.models import model
    from repro_torch.train import sharding

    max_len = max_len or s + n
    prompt = tokens[:, :s]

    def rows(t, m):
        if mesh is None:
            return t
        return sharding.local_shard(t, sharding.data_specs(t, mesh, m), mesh)

    hooks = (lambda **kw: contextlib.nullcontext()) if mesh is None else \
        (lambda **kw: model.serve_hooks(cfg, mesh, batch=b,
                                        max_len=max_len, **kw))
    with hooks(seq=s, mode=mode):
        (logits, cache), prefill_ms = synced_ms(lambda: model.prefill(
            cfg, params, {"tokens": rows(prompt, mode)}, max_len))
    out = {"logits": [logits.float().cpu()], "prefill_ms": prefill_ms,
           "decode_ms": []}
    with hooks(), collectives.tally(by="group") as counts:
        for i in range(n):
            t = rows(tokens[:, s + i:s + i + 1], "megatron")
            (logits, cache), ms = synced_ms(
                lambda: model.decode_step(cfg, params, cache, t))
            out["logits"].append(logits.float().cpu())
            out["decode_ms"].append(ms)
    out["cache"], out["collectives"] = cache, counts
    return out


def serve_world1(dev, params_host: dict, card: str) -> dict:
    """18a: NCCL at world size 1 in this process, against one card."""
    import torch.distributed as dist

    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model

    a = SERVE_MESH
    cfg = ARCHITECTURES[a["arch"]]
    params = model.map_tree(lambda t_: t_.to(dev, torch.bfloat16),
                            params_host)
    tokens = lm_inputs(cfg, a["batch"], a["seq"] + 64, 3, dev)["tokens"]
    one = serve_run(cfg, params, tokens, a["seq"], a["decode"])
    root = ROOT / "build" / "phase18"
    root.mkdir(parents=True, exist_ok=True)
    store = root / "nccl_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=dev)
        got = serve_run(cfg, params, tokens, a["seq"], a["decode"], mesh,
                        b=a["batch"])
    finally:
        dist.destroy_process_group()
    logits_equal = all(torch.equal(x, y) for x, y in
                       zip(got["logits"], one["logits"]))
    cache_equal = all(torch.equal(x, y) for x, y in zip(
        model.leaves(got["cache"]), model.leaves(one["cache"])))
    summary = {"arch": cfg.name, "batch": a["batch"], "prefill": a["seq"],
               "decode_steps": a["decode"], "logits_bit_equal": logits_equal,
               "cache_bit_equal": cache_equal,
               "prefill_ms": got["prefill_ms"],
               "one_card_prefill_ms": one["prefill_ms"],
               "decode_ms": got["decode_ms"],
               "one_card_decode_ms": one["decode_ms"], "card": card}
    print(f"SERVE-MESH 18a {cfg.name} world 1 (nccl): prefill "
          f"{a['batch']}x{a['seq']} {got['prefill_ms']:.1f} ms (one card "
          f"{one['prefill_ms']:.1f}), decode "
          f"{statistics.median(got['decode_ms'][2:]):.1f} ms a step (one "
          f"card {statistics.median(one['decode_ms'][2:]):.1f}; median "
          f"after 2 of {a['decode']}); logits bit-equal {logits_equal}, "
          f"every cache leaf bit-equal {cache_equal} on {card}", flush=True)
    print(f"SERVE-MESH 18a {json.dumps(summary)}", flush=True)
    del params, one, got
    torch.cuda.empty_cache()
    if not (logits_equal and cache_equal):
        raise AssertionError("18a: the served mesh at world size 1 differs "
                             "from one card")
    return summary


def serve_gloo_config(plan: dict):
    from repro_torch.configs.registry import ARCHITECTURES
    return ARCHITECTURES[plan["arch"]].replace(n_layers=plan["n_layers"])


def serve_mesh_rank(mesh, dev, plan: dict) -> dict:
    """18b on one rank of the 2x2 gloo mesh (tensors on the card): the
    seed's weights in bf16 cut to the rank's serve blocks; a megatron
    prefill and ``plan``'s decode steps, then a zero_seq prefill; each
    call's logits (the rank's rows), its cache leaves' shapes against
    ``local_shape``, its resident bytes, decode ms and collectives."""
    import torch.distributed as dist

    from repro_torch.models import model
    from repro_torch.train import sharding

    cfg = serve_gloo_config(plan)
    b, s, n = plan["batch"], plan["seq"], plan["decode"]
    full = model.map_tree(lambda t_: t_.to(torch.bfloat16),
                          model.init_params(cfg, seed=0, device=dev))
    from repro_torch.core import collectives

    blocks = sharding.shard_tree(full, model.serve_param_specs(cfg, mesh),
                                 mesh)
    del full
    with collectives.tally(by="group") as relaid:
        params = model.serve_params(cfg, blocks, mesh)
    del blocks
    tokens = lm_inputs(cfg, b, s + 64, 3, dev)["tokens"]
    out = {"rank": dist.get_rank(),
           "data": mesh.get_local_rank("data"), "relayout": relaid,
           "model_group": tuple(dist.get_process_group_ranks(
               mesh.get_group("model")))}
    for mode, steps in (("megatron", n), ("zero_seq", 0)):
        layout = model.cache_layout(cfg, mesh, b, s + steps)
        shapes = model.cache_shapes(cfg, b, s + steps)
        dist.barrier()
        run = serve_run(cfg, params, tokens, s, steps, mesh, mode, b)
        wrong = [p for p, sp in ((p, model.specs_at(layout, p)) for p in
                                 (("layers", "k"), ("layers", "v")))
                 if tuple(model.specs_at(run["cache"], p).shape)
                 != sharding.local_shape(model.specs_at(shapes, p).shape,
                                         sp, mesh)]
        out[mode] = {"logits": run["logits"], "wrong_shapes": wrong,
                     "prefill_ms": run["prefill_ms"],
                     "decode_ms": run["decode_ms"],
                     "collectives": run["collectives"],
                     "resident_bytes": tree_bytes(params, run["cache"])}
        del run
    torch.cuda.empty_cache()
    return out


def serve_rows_check(label: str, got, want) -> dict:
    """The mesh's logits against one card's, by 16a's decode rule: each
    row's correlation above DECODE_CORR and its largest gap within
    DECODE_GAP of its logits' range; the measured figures returned."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(
        -1, want.shape[-1])
    gap = (got - want).abs().amax(-1)
    rng = want.amax(-1) - want.amin(-1)
    rel = float((gap / rng).max())
    corr = min(float(torch.corrcoef(torch.stack([g, w]))[0, 1])
               for g, w in zip(got, want))
    flips = int((got.argmax(-1) != want.argmax(-1)).sum())
    if corr <= DECODE_CORR or rel > DECODE_GAP or not torch.isfinite(
            got).all():
        raise AssertionError(f"{label}: gap {rel} corr {corr}")
    return {"max_rel_gap": rel, "min_corr": corr, "argmax_flips": flips}


def serve_gloo(dev, card: str, ranks: list) -> dict:
    """18b (see the module docstring): the ranks' results (``ranks``, from
    phase 17's spawn) against the same calls on one card."""
    from repro_torch.models import model

    plan = SERVE_GLOO
    cfg = serve_gloo_config(plan)
    b, s, n = plan["batch"], plan["seq"], plan["decode"]
    params = model.map_tree(lambda t_: t_.to(torch.bfloat16),
                            model.init_params(cfg, seed=0, device=dev))
    tokens = lm_inputs(cfg, b, s + 64, 3, dev)["tokens"]
    one = serve_run(cfg, params, tokens, s, n)
    one_bytes = tree_bytes(params, one["cache"])
    del params
    torch.cuda.empty_cache()
    per = b // 2
    summary = {"arch": cfg.name, "n_layers": plan["n_layers"], "batch": b,
               "prefill": s, "decode_steps": n, "card": card,
               "beside": BESIDE["18"]}
    for mode in ("megatron", "zero_seq"):
        calls = len(ranks[0][mode]["logits"])
        full = []
        for i in range(calls):
            rows = [None, None]
            for r in ranks:
                got = r[mode]["logits"][i]
                d = r["data"]
                if rows[d] is not None and not torch.equal(rows[d], got):
                    raise AssertionError(f"18b {mode}: the model ranks of "
                                         f"data {d} differ at call {i}")
                rows[d] = got
            full.append(torch.cat(rows))
        for r in ranks:
            if r[mode]["wrong_shapes"]:
                raise AssertionError(f"18b {mode}: rank {r['rank']}'s "
                                     f"cache {r[mode]['wrong_shapes']} off "
                                     "local_shape")
        check = serve_rows_check(f"18b {mode}", torch.stack(full),
                                 torch.stack(one["logits"][:calls]))
        rec = ranks[0][mode]
        steps = max(1, len(rec["decode_ms"]))
        coll = step_tally(rec["collectives"], steps)
        summary[mode] = dict(
            check, prefill_ms=rec["prefill_ms"], decode_ms=rec["decode_ms"],
            one_card_prefill_ms=one["prefill_ms"],
            one_card_decode_ms=one["decode_ms"],
            collectives_a_step=coll,
            resident_bytes_by_rank=[r[mode]["resident_bytes"]
                                    for r in ranks],
            one_card_bytes=one_bytes)
        dec = (f", decode {statistics.median(rec['decode_ms'][1:]):.1f} ms "
               f"a step (rank 0, median after 1 of {n}; one card "
               f"{statistics.median(one['decode_ms'][1:]):.1f})"
               if rec["decode_ms"] else "")
        print(f"SERVE-MESH 18b {mode} 2x2 gloo {cfg.name} "
              f"{plan['n_layers']} layers: prefill {b}x{s} "
              f"{rec['prefill_ms']:.1f} ms (one card "
              f"{one['prefill_ms']:.1f}){dec}; logits against one card: "
              f"largest gap {check['max_rel_gap']:.2e} of a row's range "
              f"(bound {DECODE_GAP}), min corr {check['min_corr']:.6f}, "
              f"{check['argmax_flips']} argmax flips of {b * calls} rows; "
              f"every rank's K/V cache of local_shape's shapes; resident "
              f"{max(summary[mode]['resident_bytes_by_rank']) / 2**30:.3f} "
              f"GiB a rank against {one_bytes / 2**30:.3f} on one card on "
              f"{card}; {BESIDE['18']}", flush=True)
        if rec["decode_ms"]:
            totals = tally_lines(f"SERVE-MESH 18b {mode} decode", coll,
                                 ranks[0]["model_group"], "step")
            summary[mode]["decode_totals"] = totals
            if totals["weights"]["calls"] or totals["relayout"]["calls"]:
                raise AssertionError(f"18b {mode}: a decode step moved "
                                     f"weights: {totals}")
            if totals["all"]["bytes"] >= DECODE_BYTES_BEFORE:
                raise AssertionError(
                    f"18b {mode}: {totals['all']['bytes']} B a decode step "
                    f"a rank, not below {DECODE_BYTES_BEFORE}")
    summary["relayout_once"] = tally_lines(
        "SERVE-MESH 18b serve_params (once)", ranks[0]["relayout"],
        ranks[0]["model_group"], "call")["relayout"]
    print(f"SERVE-MESH 18b {json.dumps(summary)}", flush=True)
    return summary


def serve_ssm_rank(mesh, dev, plan: dict) -> dict:
    """18d on one rank of the 2x2 gloo mesh: the seed's weights in bf16
    cut to the rank's serve blocks and re-laid (``serve_params``); a
    megatron prefill and ``plan``'s decode steps, then a zero_seq prefill;
    each call's logits (the rank's rows), every cache leaf's shape against
    ``local_shape``, decode ms and collectives (the zero_seq prefill's by
    name)."""
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.models import model
    from repro_torch.train import sharding

    cfg = serve_gloo_config(plan)
    b, s, n, max_len = (plan[k] for k in ("batch", "seq", "decode",
                                          "max_len"))
    full = model.map_tree(lambda t_: t_.to(torch.bfloat16),
                          model.init_params(cfg, seed=0, device=dev))
    params = model.serve_params(cfg, sharding.shard_tree(
        full, model.serve_param_specs(cfg, mesh), mesh), mesh)
    del full
    tokens = lm_inputs(cfg, b, s + 64, 3, dev)["tokens"]
    dist.barrier()
    run = serve_run(cfg, params, tokens, s, n, mesh, "megatron", b, max_len)
    layout = model.cache_layout(cfg, mesh, b, max_len)
    shapes = model.cache_shapes(cfg, b, max_len)
    wrong = []
    sharding.map_with_path(
        lambda p, x: None if tuple(x.shape) == sharding.local_shape(
            model.specs_at(shapes, p).shape, model.specs_at(layout, p), mesh)
        else wrong.append("/".join(p)), run["cache"])
    out = {"rank": dist.get_rank(), "data": mesh.get_local_rank("data"),
           "model_group": tuple(dist.get_process_group_ranks(
               mesh.get_group("model"))),
           "logits": run["logits"], "wrong_shapes": wrong,
           "prefill_ms": run["prefill_ms"], "decode_ms": run["decode_ms"],
           "collectives": run["collectives"],
           "resident_bytes": tree_bytes(params, run["cache"])}
    del run
    torch.cuda.empty_cache()
    # a zero_seq prefill: each rank's recurrences on its positions, the
    # carries from the last model rank
    dist.barrier()
    with collectives.tally(by="what") as counts:
        run = serve_run(cfg, params, tokens, s, 0, mesh, "zero_seq", b,
                        max_len)
    wrong = []
    sharding.map_with_path(
        lambda p, x: None if tuple(x.shape) == sharding.local_shape(
            model.specs_at(shapes, p).shape, model.specs_at(layout, p), mesh)
        else wrong.append("/".join(p)), run["cache"])
    out["zero_seq"] = {"logits": run["logits"][0], "wrong_shapes": wrong,
                       "prefill_ms": run["prefill_ms"],
                       "collectives": counts}
    del params, run
    torch.cuda.empty_cache()
    return out


def serve_ssm_check(dev, card: str, plan: dict, ranks: list) -> dict:
    """18d (see the module docstring): the ranks' results against the same
    calls on one card; SERVE-MESH lines."""
    from repro_torch.models import model

    cfg = serve_gloo_config(plan)
    b, s, n, max_len = (plan[k] for k in ("batch", "seq", "decode",
                                          "max_len"))
    params = model.map_tree(lambda t_: t_.to(torch.bfloat16),
                            model.init_params(cfg, seed=0, device=dev))
    tokens = lm_inputs(cfg, b, s + 64, 3, dev)["tokens"]
    one = serve_run(cfg, params, tokens, s, n, max_len=max_len)
    one_bytes = tree_bytes(params, one["cache"])
    del params
    torch.cuda.empty_cache()
    per = b // 2
    full = []
    for i in range(1 + n):
        rows = [None, None]
        for r in ranks:
            got = r["logits"][i]
            d = r["data"]
            if rows[d] is not None and not torch.equal(rows[d], got):
                raise AssertionError(f"18d {cfg.name}: the model ranks of "
                                     f"data {d} differ at call {i}")
            rows[d] = got
        full.append(torch.cat(rows))
    for r in ranks:
        if r["wrong_shapes"]:
            raise AssertionError(f"18d {cfg.name}: rank {r['rank']}'s "
                                 f"cache {r['wrong_shapes']} off local_shape")
    check = serve_rows_check(f"18d {cfg.name}", torch.stack(full),
                             torch.stack(one["logits"]))
    rec = ranks[0]
    coll = step_tally(rec["collectives"], n)
    label = f"SERVE-MESH 18d {cfg.name}"
    summary = dict(check, arch=cfg.name, n_layers=cfg.n_layers, batch=b,
                   prefill=s, decode_steps=n, cache=max_len,
                   rows_a_rank=per, prefill_ms=rec["prefill_ms"],
                   decode_ms=rec["decode_ms"],
                   one_card_prefill_ms=one["prefill_ms"],
                   one_card_decode_ms=one["decode_ms"],
                   collectives_a_step=coll,
                   resident_bytes_by_rank=[r["resident_bytes"]
                                           for r in ranks],
                   one_card_bytes=one_bytes, card=card,
                   beside=BESIDE["18"])
    print(f"{label} {cfg.n_layers} layers, 2x2 gloo, megatron: prefill "
          f"{b}x{s} {rec['prefill_ms']:.1f} ms (one card "
          f"{one['prefill_ms']:.1f}), decode "
          f"{statistics.median(rec['decode_ms'][1:]):.1f} ms a step (rank "
          f"0, median after 1 of {n}; one card "
          f"{statistics.median(one['decode_ms'][1:]):.1f}); logits against "
          f"one card: largest gap {check['max_rel_gap']:.2e} of a row's "
          f"range (bound {DECODE_GAP}), min corr {check['min_corr']:.6f}, "
          f"{check['argmax_flips']} argmax flips of {b * (1 + n)} rows; "
          f"every rank's cache leaves of local_shape's shapes; resident "
          f"{max(summary['resident_bytes_by_rank']) / 2**30:.3f} GiB a rank "
          f"against {one_bytes / 2**30:.3f} on one card on {card}; "
          f"{BESIDE['18']}", flush=True)
    totals = tally_lines(f"{label} decode", coll, rec["model_group"], "step")
    summary["decode_totals"] = totals
    summary["predicted_bytes"] = SERVE_SSM_PREDICTED[cfg.name]
    summary["bytes_before"] = SERVE_SSM_BEFORE[cfg.name]
    print(f"{label} decode bytes in a step a rank {totals['all']['bytes']}"
          f" (predicted by tools/torch_mesh_tally.py "
          f"{SERVE_SSM_PREDICTED[cfg.name]}; before the split "
          f"{SERVE_SSM_BEFORE[cfg.name]})", flush=True)
    print(f"{label} {json.dumps(summary)}", flush=True)
    moved = [k for k in coll if " weights" in k or " relayout " in k
             or "decode state" in k]
    if moved:
        raise AssertionError(f"18d {cfg.name}: a decode step moved weights "
                             f"or an SSM state: {moved}")
    if totals["all"]["bytes"] != SERVE_SSM_PREDICTED[cfg.name]:
        raise AssertionError(f"18d {cfg.name}: {totals['all']['bytes']} B "
                             "a decode step a rank, not the "
                             f"{SERVE_SSM_PREDICTED[cfg.name]} predicted")
    summary["zero_seq"] = serve_seq_check(cfg, ranks, one, card)
    return summary


def serve_seq_check(cfg, ranks: list, one: dict, card: str) -> dict:
    """18d's zero_seq prefill: the model ranks of a row block bit-equal,
    the logits against one card's prefill by 16a's decode rule, every
    cache leaf of ``local_shape``'s shape, no ``sequence in`` gather; a
    SERVE-MESH line."""
    rows = [None, None]
    for r in ranks:
        got, d = r["zero_seq"]["logits"], r["data"]
        if rows[d] is not None and not torch.equal(rows[d], got):
            raise AssertionError(f"18d {cfg.name} zero_seq: the model "
                                 f"ranks of data {d} differ")
        rows[d] = got
        if r["zero_seq"]["wrong_shapes"]:
            raise AssertionError(f"18d {cfg.name} zero_seq: rank "
                                 f"{r['rank']}'s cache "
                                 f"{r['zero_seq']['wrong_shapes']} off "
                                 "local_shape")
    check = serve_rows_check(f"18d {cfg.name} zero_seq", torch.cat(rows),
                             one["logits"][0])
    coll = ranks[0]["zero_seq"]["collectives"]
    gathered = sorted(set(coll) & set(SEQ_GATHERS))
    seq = {k: coll[k]["bytes"] for k in coll if " seq " in k
           or k.startswith("all_to_all cache ")}
    out = dict(check, prefill_ms=ranks[0]["zero_seq"]["prefill_ms"],
               one_card_prefill_ms=one["prefill_ms"], exchanges=seq,
               sequence_gathers=gathered, card=card)
    print(f"SERVE-MESH 18d {cfg.name} zero_seq prefill "
          f"{out['prefill_ms']:.1f} ms (rank 0; one card "
          f"{one['prefill_ms']:.1f}): logits against one card's prefill: "
          f"largest gap {check['max_rel_gap']:.2e} of a row's range (bound "
          f"{DECODE_GAP}), min corr {check['min_corr']:.6f}; rank-boundary "
          f"exchanges and the carries' moves on rank 0 (B in): {seq}; "
          f"sequence gathers: {gathered or 'none'}; {json.dumps(out)}",
          flush=True)
    if gathered:
        raise AssertionError(f"18d {cfg.name} zero_seq: {gathered}")
    return out


def serve_dry_run_start():
    """18c: one workload of the pod dry run, started in a process of its
    own (its fake process group never meets a real one; it needs no card
    and runs beside phase 17 and 18a); :func:`serve_dry_run_check`
    waits."""
    arch, shape = SERVE_DRY
    root = ROOT / "build" / "phase18"
    root.mkdir(parents=True, exist_ok=True)
    out = root / "dryrun.json"
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--multi-pod", "--json", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out


def serve_dry_run_check(started, card: str) -> dict:
    """18c's record: status ``ok``, its bytes and roofline terms."""
    proc, out = started
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0 or not out.exists():
        raise AssertionError(f"18c: dry run exit {proc.returncode}: "
                             f"{stdout[-2000:]} {stderr[-2000:]}")
    (rec,) = json.loads(out.read_text())
    if rec["status"] != "ok":
        raise AssertionError(f"18c: {rec}")
    arch, shape = SERVE_DRY
    print(f"SERVE-MESH 18c dry run {arch} {shape} {rec['mesh']}: "
          f"{rec['status']} (its run {rec['run_s']} s, in a process beside "
          "phase 17; "
          f"no card, a fake group of 512); resident "
          f"{rec['resident_total_bytes'] / 2**30:.3f} GiB a rank, "
          f"collectives {rec['coll_bytes']:.0f} B a step a rank; roofline "
          f"compute {rec['t_compute_s']:.3e} s, memory "
          f"{rec['t_memory_s']:.3e} s, collective "
          f"{rec['t_collective_s']:.3e} s ({rec['bottleneck']}; H100 "
          f"constants, the card here {card})", flush=True)
    return rec


def serve_mesh_phase(dev, params_host: dict, ranks18: dict, dry,
                     card: str) -> dict:
    """Phase 18: 18a, 18b's and 18d's checks of their ranks' results (run
    in phase 17's spawn), then 18c's record (``dry``: its process, started
    before phase 17); SERVE-MESH lines."""
    t = time.perf_counter()
    out = {"18a": serve_world1(dev, params_host, card)}
    phase("serve-mesh 18a", t)
    t = time.perf_counter()
    out["18b"] = serve_gloo(dev, card, ranks18["18b"])
    phase("serve-mesh 18b (its one-card side and checks)", t)
    t = time.perf_counter()
    out["18d"] = [serve_ssm_check(dev, card, p, [r[i] for r in
                                                 ranks18["18d"]])
                  for i, p in enumerate(SERVE_SSM)]
    phase("serve-mesh 18d (its one-card side and checks)", t)
    t = time.perf_counter()
    out["18c"] = serve_dry_run_check(dry, card)
    phase("serve-mesh 18c (the rest of its wait)", t)
    return out



def sum_device_ms(fn, reps: int) -> float:
    """Median milliseconds, on the device's clock, of all the device work
    one call of ``fn`` enqueues (several kernels): a torch.profiler trace
    of ``reps`` calls, each inside its own range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            with record_function(f"call {i}"):
                fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range for e in events
                    if e.device_type == cuda and e.name.startswith("call ")),
                   key=lambda r: r.start)
    kernels = [e.time_range for e in events
               if e.device_type == cuda and not e.name.startswith("call ")]
    per_call = [sum(k.elapsed_us() for k in kernels
                    if sp.start <= k.start < sp.end) / 1e3 for sp in spans]
    if not per_call:
        print(f"sum_device_ms: no device-side range of {reps} calls traced",
              flush=True)
        return float("nan")
    return statistics.median(per_call)


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = card_line()
    print(f"CARD {card}", flush=True)
    dev = torch.device("cuda")
    phase("card", t0)

    from repro_torch.kernels import _build
    t = time.perf_counter()
    secs = _build.build_all()
    print(f"BUILD {secs:.1f} s nvcc (all sources in parallel)")
    for stem, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{stem}] {line.strip()}")
    phase("build", t)

    from repro_torch.core import hdp, lda, pdp
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine import Trainer, TrainerConfig

    t = time.perf_counter()
    ccfg = CorpusConfig(n_topics=64, vocab_size=131072, n_docs=65536,
                        doc_len=256, seed=0)
    tokens, mask, phi = make_topic_corpus(ccfg)
    ho = held_out_docs(phi, 32, ccfg.doc_len, seed=1)
    n_tok = int(mask.sum())
    print(f"CORPUS {ccfg} tokens={n_tok} ({time.perf_counter() - t:.1f} s)")
    if n_tok >= 1 << 24:
        raise AssertionError("counts must stay below 2^24 to stay exact")
    cfg = lda.LDAConfig(n_topics=1024, vocab_size=131072)
    v, k = cfg.vocab_size, cfg.n_topics
    phase("corpus", t)

    tc_cad = TrainerConfig(layout="sorted", n_clients=2, consistency="bsp")
    tc_inc = TrainerConfig(layout="sorted", n_clients=2, consistency="bsp",
                           alias_rebuild_threshold=0.0,
                           alias_rebuild_rows=GATHER_ROWS,
                           alias_full_rebuild_every=16)
    counts, serving = {}, {}

    # ---------------------------------------------------------- phase 3
    t = time.perf_counter()
    tr = Trainer(cfg, tokens, mask, config=tc_cad, seed=0, device=dev)
    shared = tr.shared
    rows3 = torch.argsort(-shared.n_wk.sum(1), stable=True)[
        :GATHER_ROWS].to(torch.int32)
    prior = torch.full((k,), cfg.alpha, dtype=torch.float32, device=dev)
    report = lm_kernels(dev, tr, cfg, ccfg, lda.dense_probs(cfg, shared),
                        prior, rows3)
    report[0]["adversarial"] = adversarial_check("alias_build", dev)
    report[1]["adversarial"] = adversarial_check("alias_build_gather_fused",
                                                 dev)
    report.append(doc_list_kernel(tr.locals_[0].n_dk))
    del shared
    first = {"cadence": tr}
    del tr
    torch.cuda.empty_cache()
    phase("lda-kernels", t)

    # ---------------------------------------------------------- phase 4
    t = time.perf_counter()
    vk, dk = v * k * 4, 2 * 32768 * k * 4    # a (V,K) f32; two (D,K) n_dk
    lays = 2 * n_tok * 4 * 4                 # order, rows, docs, real
    gib = (7 * vk + dk + lays + 5 * cfg.mh_steps * 2_200_000 * 4) / 2**30
    note = (f"~{gib:.1f} GiB: n_wk, its delta, the push sum, stale, prob, "
            "alias and the build's transients as (V,K) f32; two (D,K) "
            "n_dk; layouts; uniforms")
    counts["lda"], peak_lda, tr = train(
        "lda", cfg, (("cadence", tc_cad, 4), ("incremental", tc_inc, 3)),
        tokens, mask, ho, dev, first,
        {"sweep": "mhw_sweep_fused", "lists": "doc_topic_lists",
         "full": "alias_build", "rows": "alias_build_gather_fused"}, note)
    phase("lda-train", t)

    # --------------------------------------------------------- phase 4s
    t = time.perf_counter()
    counts["serve-lda"], serving["lda"] = serve_path(
        "serve-lda", tr, phi, 256, 8, card, ho=ho, tcp=True, ckpt=True)
    del tr
    torch.cuda.empty_cache()
    phase("serve-lda", t)

    # ---------------------------------------------------------- phase 5
    t = time.perf_counter()
    pcfg = pdp.PDPConfig(n_topics=1024, vocab_size=131072)
    tr = Trainer(pcfg, tokens, mask, config=tc_cad, seed=0, device=dev)
    report += pdp_kernels(dev, tr, pcfg, ccfg, report[0])
    first = {"cadence": tr}
    del tr
    torch.cuda.empty_cache()
    phase("pdp-kernels", t)

    # ---------------------------------------------------------- phase 6
    t = time.perf_counter()
    gib = (16 * vk + 9 * 2 * vk + dk + lays) / 2**30
    note = (f"~{gib:.1f} GiB: "
            "m_wk and s_wk, their per-client deltas and sums, the push "
            "sum and the projection's copies as 16 (V,K) f32; prob, "
            "alias, stale and the dense build's transients as 9 (V,2K); "
            "two (D,K) n_dk; layouts")
    counts["pdp"], _, tr = train(
        "pdp", pcfg, (("cadence", tc_cad, 3), ("incremental", tc_inc, 3)),
        tokens, mask, ho, dev, first,
        {"sweep": "pdp_sweep_fused", "lists": "doc_topic_lists",
         "full": "alias_build", "rows": "alias_build_rows"}, note)
    phase("pdp-train", t)

    # --------------------------------------------------------- phase 6s
    t = time.perf_counter()
    counts["serve-pdp"], serving["pdp"] = serve_path("serve-pdp", tr, phi,
                                                     64, 4, card)
    del tr
    torch.cuda.empty_cache()
    phase("serve-pdp", t)

    # ---------------------------------------------------------- phase 7
    t = time.perf_counter()
    hcfg = hdp.HDPConfig(n_topics=1024, vocab_size=131072)
    tr = Trainer(hcfg, tokens, mask, config=tc_cad, seed=0, device=dev)
    before = tr.shared.n_wk.clone()
    tr.step()                      # θ0 resampled from the CRT table counts
    shared = tr.shared
    drift = (shared.n_wk - before).abs().sum(1)
    del before
    rows3 = torch.argsort(-drift, stable=True)[:GATHER_ROWS].to(torch.int32)
    prior = tr.family.sparse_prior(hcfg, shared)
    theta = {"theta0_min": float(shared.theta0.min()),
             "theta0_max": float(shared.theta0.max()),
             "prior_max_over_min": float(prior.max() / prior.min()),
             "m_k_sum": float(shared.m_k.sum())}
    print(f"HDP prior b1*theta0 after one round {json.dumps(theta)}")
    if not theta["theta0_max"] > theta["theta0_min"]:
        raise AssertionError("HDP: theta0 is uniform after a round")
    hrep = lm_kernels(dev, tr, hcfg, ccfg, hdp.dense_probs(hcfg, shared),
                      prior, rows3, label=" (hdp)")
    for entry, h in zip(report[:3], hrep):
        entry["hdp_prior"] = {n: x for n, x in h.items() if n not in (
            "name", "route", "source", "replaces", "library_ms")}
        entry["hdp_prior"].update(theta)
    del shared, drift, prior
    first = {"cadence": tr}
    del tr
    torch.cuda.empty_cache()
    phase("hdp-kernels", t)

    # ---------------------------------------------------------- phase 8
    t = time.perf_counter()
    crt = n_tok * 8 * 5                      # CRT entries: 5 8-byte temps
    gib = (7 * vk + 2 * dk + lays + 5 * cfg.mh_steps * 2_200_000 * 4
           + crt) / 2**30
    note = (f"~{gib:.1f} GiB: LDA's reckoning plus two (D,K) m_dk and the "
            "CRT step's per-draw temporaries (a client's tokens at most, "
            "nothing of shape (D,K,crt_max))")
    # HDP's document prior b1·θ0 has a total mass of 1 against LDA's α·K =
    # 102.4, so the fold-in estimate of θ_d on a few held-out documents is
    # noisy: on phase 4's 32 documents HDP's perplexity rose in rounds 3-4
    # while 256 documents saw it fall at every round measured.  HDP is
    # held to 256 held-out documents and 5 rounds a mode.
    ho_hdp = held_out_docs(phi, 256, ccfg.doc_len, seed=2)
    counts["hdp"], peak_hdp, tr = train(
        "hdp", hcfg, (("cadence", tc_cad, 5), ("incremental", tc_inc, 5)),
        tokens, mask, ho_hdp, dev, first,
        {"sweep": "mhw_sweep_fused", "lists": "doc_topic_lists",
         "full": "alias_build", "rows": "alias_build_gather_fused"}, note)
    print(f"MEMORY hdp peak minus lda peak {peak_hdp - peak_lda:+.2f} GiB")
    phase("hdp-train", t)

    # --------------------------------------------------------- phase 8s
    t = time.perf_counter()
    counts["serve-hdp"], serving["hdp"] = serve_path("serve-hdp", tr, phi,
                                                     64, 4, card)
    del tr
    torch.cuda.empty_cache()
    phase("serve-hdp", t)

    # ---------------------------------------------------------- phase 9
    t = time.perf_counter()
    fcfg = lda.LDAConfig(n_topics=1024, vocab_size=131072,
                         fused_alias_build=True)
    tr = Trainer(fcfg, tokens, mask, config=tc_cad, seed=0, device=dev)
    report.append(fused_kernel(tr, fcfg))
    note = "as phase 4's LDA, the dense term formed inside kernel 6"
    counts["lda-fused"], _, tr = train(
        "lda-fused", fcfg, (("cadence", tc_cad, 3),), tokens, mask, ho,
        dev, {"cadence": tr},
        {"sweep": "mhw_sweep_fused", "lists": "doc_topic_lists",
         "full": "alias_build_fused"}, note)
    phase("lda-fused", t)

    # --------------------------------------------------------- phase 9s
    t = time.perf_counter()
    counts["serve-lda-fused"], serving["lda-fused"] = serve_path(
        "serve-lda-fused", tr, phi, 8, 2, card)
    phase("serve-lda-fused", t)

    # --------------------------------------------------------- phase 10
    t = time.perf_counter()
    drawn, counts["draws"] = draw_kernels(dev, tr, fcfg, ccfg)
    report += drawn
    del tr
    torch.cuda.empty_cache()
    phase("draws", t)

    # ------------------------------------------------------ the launcher
    t = time.perf_counter()
    serving["launcher"] = launcher_smoke()
    phase("serve-launcher", t)

    # --------------------------------------------------------- phase 12
    t = time.perf_counter()
    counts.update(consistency_and_faults(cfg, tokens, mask, ho, dev,
                                         ROOT / "build" / "phase12"))
    phase("consistency-faults", t)

    # --------------------------------------------------------- phase 13
    t = time.perf_counter()
    wire_corpus = (tokens[:WIRE_DOCS], mask[:WIRE_DOCS])
    counts.update(wire(cfg, pcfg, dataclasses.replace(ccfg, n_docs=WIRE_DOCS),
                       *wire_corpus, dev, ROOT / "build" / "phase13"))
    paths_line("13")
    phase("wire", t)

    # --------------------------------------------------------- phase 14
    t = time.perf_counter()
    scan_counts, scan_figures = scan(cfg, pcfg, hcfg, tokens, mask, ho,
                                     ho_hdp, dev, wire_corpus)
    counts.update(scan_counts)
    for entry in report:
        if entry["name"] in ("alias_sample", "mh_accept"):
            entry["scan_grid"] = scan_figures["lda"][entry["name"]]
            entry["scan_grid_pdp"] = scan_figures["pdp"][entry["name"]]
    paths_line("14")
    phase("scan", t)

    # --------------------------------------------------------- phase 15
    t = time.perf_counter()
    torch.cuda.empty_cache()
    mesh_counts, _ = mesh_world1(cfg, pcfg, hcfg, tokens, mask, ho, ho_hdp,
                                 dev, ROOT / "build" / "phase15")
    counts.update(mesh_counts)
    phase("mesh-nccl", t)
    t2 = time.perf_counter()
    mesh_counts, _ = mesh_gloo(cfg, tokens, mask, dev,
                               ROOT / "build" / "phase15")
    counts.update(mesh_counts)
    paths_line("15")
    phase("mesh-gloo", t2)
    phase("mesh", t)

    # ------------------------------------------------- phases 16, 17, 18
    # Phase 17's four ranks start first (see PHASE16_DONE; the time limit):
    # 17b's one-card side and phase 16 run beside their start, 17b, 18b and
    # 18d, and 17a and the one-card sides of 17c and 17d beside their 17d;
    # 17c has the card alone.  18c's dry run needs no card: its process
    # runs beside phase 17.
    root17 = ROOT / "build" / "phase17"
    box = mesh_lm_start(dev, root17)
    dry = None
    try:
        t = time.perf_counter()
        torch.cuda.empty_cache()
        one17 = one_card_runs(dev, MESH_LM, root17)
        phase("mesh-lm 17b one card (beside the ranks)", t)
        t = time.perf_counter()
        state16: dict = {}
        lm_phase(dev, ROOT / "build" / "phase16", card, state16)
        torch.cuda.empty_cache()
        (root17 / PHASE16_DONE).write_text("")
        phase("lm (beside the ranks)", t)
        dry = serve_dry_run_start()
        t = time.perf_counter()
        params16 = state16["params"]          # 16a's final state, for 18a
        lm17 = mesh_lm_phase(dev, state16, root17, card, box, one17)
        del state16
        phase("mesh-lm", t)
        t = time.perf_counter()
        torch.cuda.empty_cache()
        serve_mesh_phase(dev, params16, lm17["18 ranks"], dry, card)
        del params16
        phase("serve-mesh", t)
        t = time.perf_counter()
        lm17["17b"]["17c"]["zero_seq step"] = moe_seq_step_check(
            box["moe_steps"], card)
        del lm17
        phase("mesh-lm 17c zero_seq step (the rest of its wait)", t)
    finally:
        if "moe_steps" in box:
            box["moe_steps"]["thread"].join()
        if box["thread"].is_alive():     # never leave the ranks waiting
            root17.mkdir(parents=True, exist_ok=True)
            for name in (PHASE16_DONE, MAIN_IDLE):
                (root17 / name).write_text("")
            box["thread"].join()
        if dry is not None and dry[0].poll() is None:
            dry[0].kill()
            dry[0].communicate()

    for entry in report:
        if entry["name"] in ("mhw_sweep_fused", "pdp_sweep_fused"):
            entry["serve_chunk"] = {
                label: s["serve_chunk"] for label, s in serving.items()
                if "serve_chunk" in s and (entry["name"] == "pdp_sweep_fused")
                == (label == "pdp")}

    for entry in report:
        by_path = {p: c.get(entry["name"], 0) for p, c in counts.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} never launched on a "
                                 "main path")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
