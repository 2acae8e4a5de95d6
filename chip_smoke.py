#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
the repository around this file; it exits non-zero otherwise, and on any
failed check.  Imports nothing of JAX or of the reference package ``repro``.

Phases (each prints its own lines):

1. card and build -- ``nvidia-smi`` name and power limit; every kernel of
   ``src/repro_torch/csrc`` compiled at once by ``nvcc`` for ``sm_90a``.
2. the ``mma.sync`` rates K3's design rests on (binary m16n8k256 beside
   int8 m16n8k32, issued back to back from registers by every SM); then
   kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them: ``binary_qmm`` (K1) equal int32 (at
   granite-8b's and bit-bert-base's sites, with the tile and K splits its
   plan chose; and at gemma3-27b's decode sites and its 128-token up
   site; at deepseek-v2-lite-16b's decode sites and its prefill's k_up /
   v_up; at the recurrent families' decode sites and 128-token prefills;
   at internvl2-2b's decode sites and its 320-token image prefill's up
   site, and at whisper-tiny's decode sites and its cross-attention k / v
   over 4 x 1,500 encoder rows),
   ``fused_qmm`` (K2, also at gemma3-27b's decode sites)
   bitwise-equal float32, ``popcount_qmm`` (K3, with its plan's tile and
   K splits, and K4 at A1xA1 -- the same sum -- timed beside it) and
   ``bitserial_qmm`` (K4) equal int32.  Each is timed on the device (a
   replayed CUDA graph, weights rotated through more than the 50 MB L2, as
   a decode finds them) and as issued eagerly from Python, beside its
   bound (K3's operations at the binary rate ``PEAK_B1_OPS_PER_S``), its
   plain version and one PyTorch call computing the same
   function (``library_ms``; a yardstick the port never calls).  K2's rows
   with M > 16 add ``torch._int_mm`` on its integer core (``int_mm_ms``).
3. main path: granite-8b at full width and depth (36 layers, random
   weights from a seed) served through ``ServeEngine`` with the ``pallas``
   backend: 8 requests, prompts of 32-128 tokens, 16 new tokens each.  The
   engine prefills each prompt eagerly and decodes by replaying its
   compiled step (``make_decode_step``, a CUDA graph captured on the first
   tick).  Checks: every request ``ok``; K1's wrapper, its count zeroed
   just before the run and read just after, launched 7 x 36 times for
   each eager prefill and twice that for the capturing tick (its warm-up
   run, then the capture, which records each launch once; a replay calls
   no wrapper), and no other kernel's; greedy tokens equal
   ``serve_sequential``.  Logged: the capture's time and the graph's
   memory pool, the replayed tick's time, tokens/s and the eager
   prefills' share of the run.  Then, from one 4-slot cache, 5 eager ticks
   beside 5 calls of a compiled step, logits and every cache leaf bitwise
   equal at each tick; the eager and the replayed tick timed (wall,
   synchronised) and profiled (device busy, device span from the first
   operation to the last, idle share), K1 counted 7 x 36 times on the
   device in the profiled replay; the host time of the compiled call's
   check of its captured tensors; one eager prefill profiled; one prefill
   and decode step bitwise equal with K1 swapped for its plain version.
4. ``fused`` pass: the same model with ``backend="fused"`` for one prefill
   and 8 decode ticks; K2 launched 7 x 36 times per forward; every step's
   logits bitwise equal with K2 swapped for its plain version on the same
   tokens; logits against the ``pallas`` pass; then phase 3's 4-slot tick,
   eager beside replayed, bitwise equal, timed and profiled on the
   ``fused`` backend (K2 7 x 36 times in the profiled replay), and its
   prefill profiled.
5. bit-bert-base (W1A1) at full width (12 layers, d_model 768, random
   weights from a seed) served through ``ServeEngine`` with the ``pallas``
   backend: 4 slots, max_len 512, 8 requests of 64-128 prompt tokens, 16
   new tokens each, decoded by the replayed step as in phase 3.  Checks:
   every request ``ok``; K3's wrapper counted as K1's in phase 3 (6 x 12
   a forward) and K1, K2, K4 never; greedy tokens equal ``serve_sequential``; the 4-slot tick,
   eager beside replayed, as in phase 3 (K3 6 x 12 times in the profiled
   replay); the paper's metric, a 128-token prefill, through
   ``make_prefill`` (one capture, then replays) bitwise equal to the eager
   prefill of the same tokens, logits and cache, both timed and profiled;
   one prefill and decode step bitwise equal with K3 swapped for its plain
   version.  Then one prefill and one decode step of each of
   bit-bert-base-a2 / -a4 / -a8 (K1, 6 x 12 launches per forward), each
   bitwise equal with K1 swapped for its plain version.
6. act x act: ``qmm(x, y, backend="pallas")`` on two multi-bit activations
   at BERT-base attention (per-head Q.K^T) and FFN shapes, through K4,
   bitwise equal to the plain ``popcount`` backend.
7. gemma3-27b at full width (``SERVE_LAYERS``: 8 of its 62 layers, 7
   sliding-window ``"l"`` layers, window 1024, local rope 1e4, and 1 global
   one, rope 1e6; qk-norm, gelu FFN, tied 262,144-row table; random
   weights from a seed), ``pallas`` backend, K1 at every site (7 a layer
   a forward).  One
   prefill and decode step at max_len 512 (local layers clipped to 512
   rows) bitwise equal with K1 swapped for its plain version; then
   ``ServeEngine`` with 4 slots and max_len 2048 (local layers as
   1,024-row ring buffers) serves 8 requests of 16 new tokens: prompts of
   32-128 tokens, one of 1,300 (the ring wraps inside its prefill), one of
   1,016 (its decode crosses position 1,024) and one of 600.  Checks as in
   phase 3: every request ``ok``, K1's wrapper count, greedy tokens equal
   ``serve_sequential``, and the 4-slot tick from rows at positions 1,021,
   1,023, 1,300 and 100, eager beside replayed, bitwise equal over 5 ticks
   that carry two rows across position 1,024, timed and profiled, K1 7 a
   layer in the profiled replay; the 1,300-token eager prefill profiled.
8. deepseek-v2-lite-16b at full width (``SERVE_LAYERS``: 4 of its 27
   layers, its ``"Md"`` layer, multi-head latent attention with a dense
   FFN of 10,944, then 3 of its 26 ``"Mm"`` layers, MLA with 64 routed
   experts of 1,408, top-6, and 2 shared; d_model 2048, 16 heads, kv_lora
   512, vocab 102,400 untied; random weights from a seed), ``pallas``
   backend: K1 at every binary site, the routed experts one launch per
   expert (``k1_per_forward``: 604 launches a decode forward, 612 a
   prefill).  One prefill and decode step bitwise equal
   with K1 swapped for its plain version; the expert loop alone (64 x (C,
   2048, 1408) and (C, 1408, 2048), C = 1 and 15) bitwise equal to the
   plain version expert by expert, timed; then ``ServeEngine`` with 4
   slots and max_len 2048 serves 8 requests of 16 new tokens (prompts of
   32-128 tokens and one of 1,500).  Checks: every request ``ok``, K1's
   wrapper count (612 per eager prefill, 2 x 604 for the capturing tick);
   the 4-slot tick, eager beside replayed, bitwise equal over 5 ticks,
   timed and profiled, K1 604 times in the profiled replay; the
   1,500-token eager prefill profiled.  MoE routing depends on the batch,
   so the engine is not held to ``serve_sequential`` here (the CPU tests
   hold it to the reference's engine).
9. the recurrent families at full width, random weights from a seed,
   ``pallas`` backend, K1 at every binary site: recurrentgemma-2b
   (``SERVE_LAYERS``: 8 of its 26 layers, 6 RG-LRU ``"r"`` layers 2,560
   wide and 2 local attention ``"l"`` layers, MQA 10 heads of 256, window
   2,048; gelu-glu FFN of 7,680; tied 256,000-row table; 62 K1 launches a
   forward) at max_len
   4096 (2,048-row rings), and mamba2-130m whole (24 SSD ``"s"`` layers: d_inner
   1,536, 24 heads of 64, d_state 128, chunk 128; tied 50,280-row table;
   48 K1 launches a forward) at max_len 2048.  For each: one prefill and
   decode step bitwise equal with K1 swapped for its plain version; then
   ``ServeEngine`` with 4 slots serves 8 requests of 16 new tokens,
   prompts of 32-128 tokens and one long one (2,100 tokens, which wraps
   the ring inside its prefill; 1,000 tokens, 8 chunks with 24 rows of
   padding).  Checks as in phase 7: every request ``ok``, K1's wrapper
   count, greedy tokens equal ``serve_sequential``, and the 4-slot tick,
   eager beside replayed, bitwise equal over 5 ticks (recurrentgemma's
   from a row at position 2,046, which crosses 2,048), timed and profiled,
   K1 ``per forward`` times in the profiled replay; the long eager prefill
   profiled.
10. the encoder families at full width and depth, random weights from a
   seed, ``pallas`` backend, K1 at every binary site.  internvl2-2b (24
   layers, d_model 2048, 16 / 8 heads, silu-glu 8,192, untied 92,553-row
   tables; 168 K1 launches a forward; a patch stub of 256 x 1,024): an
   image prompt of 256 patch positions + 64 text tokens through
   ``make_prefill`` with its frontend (one capture, then two replays on
   new patches, each bitwise equal to the eager prefill on the same
   inputs, timed and profiled), then 8 greedy decode steps, logits bitwise
   equal with K1 swapped for its plain version; then ``ServeEngine`` (text
   only, as the reference's) with 4 slots and max_len 1024 serves 8
   requests of 16 new tokens, checked and profiled as in phase 3.
   whisper-tiny (4 encoder + 4 decoder layers, d_model 384, 6 heads, gelu
   1,536, tied 51,865-row table, learned decoder positions up to 448; 64
   K1 launches a prefill, 40 a decode step, 8 of them the cross-attention
   k / v at M = 4 x 1,500): ``ServeEngine`` refuses it, as the
   reference's does; a transcription -- ``make_prefill`` at batch 4 with a
   4-token prompt and stub frames (4, 1,500, 384), then 32 greedy steps of
   a replayed ``make_decode_step`` -- with K1's wrapper count; the prefill
   replayed on new frames bitwise equal to the eager prefill; the decode
   step replayed bitwise equal to the eager one over 32 ticks, timed and
   profiled; logits bitwise equal with K1 swapped for its plain version;
   the device time of the cross-attention k / v projections and of the
   float cross-attention, each alone, against the replayed tick's.
12. bitwise attention.  [12a] the AND-popcount scores kernel
   ``binary_attn_scores_planes`` (``csrc/binary_attn.cu``) bitwise against
   its plain version at bit-bert-base's 128-token prefill and 4-slot decode
   over 512 keys, a GQA decode, MLA's latent decode (dh 512, 2,048 keys)
   and ragged dh / T, on the layouts the model hands it (Q a transposed
   view, K the packed cache permuted), timed as phase 2 with its plan,
   bound and ``torch.bmm`` in float32 on the planes unpacked beforehand.
   [12b] bit-bert-base W1A1 at full width with ``attn.qk -> binary`` and
   autotuning off (``REPRO_QMM_AUTOTUNE=0``: the scores core is the
   kernel), ``ServeEngine`` with 4 slots and max_len 512 serving 8 requests
   of 16 new tokens: every request ``ok``; K3 72 and the scores kernel 12
   wrapper launches a forward; greedy tokens equal ``serve_sequential``'s
   and the ``float`` core's; the K cache's bytes beside phase 5's int8
   cache (8x fewer); the 4-slot tick and the 128-token ``make_prefill``,
   eager beside replayed, bitwise equal, timed and profiled (12 scores
   launches in each profiled replay); one prefill and decode step bitwise
   equal with the kernel swapped for its plain version.  [12c]
   ``backend="auto"`` at every site with autotuning on and a cache file in
   a temporary directory: on the card the candidates are the hand-written
   kernels only (the scores family has one, the kernel, and is not timed),
   each timed as replays of a CUDA graph of 16 calls; each key's
   candidates, times and winner logged, and every key timed again in a
   fresh cache, with how many winners agree; a second engine loading the
   file makes 0 timing runs and serves the same tokens.
13. fault-tolerant serving: granite-8b at full width and depth, W1A8 on
   ``pallas``, 4 slots, max_len 512, phase 3's 8 requests.  [13a] under
   ``ROBUST_PLAN`` (two transient tick faults, a NaN row, a failed prefill,
   a failed snapshot write) with a snapshot every 4 ticks: every request
   ``ok`` with the unfailed run's tokens (T=0.8 included), each event
   counted as the plan implies, one snapshot's ms and bytes.  [13b] the
   ``fused`` engine with ``demote_to="pallas"`` and two injected ``fused``
   faults: one demotion, a second capture, K1 6 x 252 and K2 4 x 252
   wrapper launches, a profiled replay after it with K1 252 times and K2
   none, both graph pools.  [13c] two requests with ``deadline_s=0.5``
   behind a 1 s stall end ``deadline`` in their slots, the other six ``ok``.
   [13d] (a)'s run cut at tick 13, resumed by a new engine from its last
   snapshot, twice: the outputs of an uninterrupted run, one capture, the
   restore's ms and bytes.  [13e] ``python -m repro_torch.launch.serve``
   SIGKILLed once its second snapshot is committed and resumed here, equal
   to an uninterrupted run.  [13f] the W1A8 model freed, granite-8b with
   ``FLOAT_QUANT`` (bf16 weights, ~16 GB): the engine's greedy tokens equal
   ``serve_sequential``'s, the bf16 cache's bytes beside the int8 one's,
   the replayed tick bitwise to the eager one, timed and profiled, and a
   right-padded batch of 4 through ``prefill(length=)``: logits, the real
   cache rows and a decode step bitwise the same whatever the pads hold,
   and the same argmax as each exact-length prefill (the gap logged: the
   float reductions run over the bucket's rows, ROADMAP section 3).
14. QAT training.  [14a] bit-bert-base W1A1 at full width and depth
   (12 layers, 132 M float32 latents) from ``init_params(seed 0)``: 30
   steps of 32 x 128 tokens from ``TokenPipeline(seed 0)``, AdamW (lr 1e-3,
   warm-up 5, cosine to 30), remat on.  Checks: every loss finite, the last
   below the first, no serving kernel launched.  Logged: step p50 / p99,
   peak allocated memory, trained tokens/s, one profiled step's busy time,
   idle share and top kernels.  [14b] a smoke step on the card against the
   same step on the CPU, TF32 and reduced-precision reductions off: for
   bit-bert-base and granite-8b the loss and every gradient leaf held to
   ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_TOL`` (cuBLAS sums in its own
   order), for gemma3-27b's 8 smoke layers the gaps logged as a reading.  [14c] 6 straight steps equal 3 + checkpoint
   + restore + 3, params and AdamW state bit for bit.  [14d]
   ``python -m repro_torch.launch.train`` at full width SIGTERMed once its
   first checkpoint commits; relaunched, it ends at an uninterrupted run's
   params and state, bit for bit.  [14e] the trained latents packed and
   one 128-token ``Z.prefill`` served at W1A1 through K3 (72 launches),
   logits and cache bitwise equal with K3 swapped for its plain version;
   the share of positions whose argmax is the input token under the QAT
   and the all-positions serving forward (a reading; that forward's last
   row held to ``Z.prefill``'s logits).  [14f] granite-8b at full width on 4 of its 36
   layers (all 36 would need ~131 GB with Adam): 5 steps of 4 x 512, every
   loss finite, step time and peak memory logged.  The training numbers
   go on one ``[14] training numbers`` line.
17. the paper's measurement modules on the card.  [17a]
   ``core/qmm_roofline.measure_cell`` for every registered ``qmm`` backend
   at granite-8b's W1A8 sites (``pallas`` -> K1, ``fused`` -> K2),
   bit-bert-base's W1A1 sites (``pallas`` -> K3) and A8xA8 (128, 64, 128)
   (``pallas`` -> K4), one draw of the operands a site, each cell timed as
   the autotuner times it (a CUDA graph of 16 calls, operands rotated
   through copies past twice the L2) beside the H100's roofs; the plain
   cores are not timed at granite's 128-row up site (``PLAIN_UNTIMED``);
   the table with each cell's share of its roof (over 1.0 raises), and
   each kernel cell's product bitwise equal to the same call on the
   kernel's plain version.  [17b]
   ``core/attn_bench.run_attn_bench`` over every scores backend at
   bit-bert's prefill, its 4-slot decode and a GQA decode, the scores
   kernel bitwise against its plain version.  [17c] the paper's metric:
   bit-bert-base's 128-token prefill through ``make_prefill`` replayed back
   to back for ``GOPS_W_SECONDS`` at W1A1 (K3) and W1A2 / A4 / A8 (K1), the
   card's energy read from NVML (``libnvidia-ml.so.1`` through ``ctypes``,
   the handle matched to the CUDA device by UUID) around the loop and over
   ``IDLE_SECONDS`` idle before it; GOPS counted as the paper counts them
   (``core/energy_model.bert_base_qmm_workload``: 22.35 G operations a
   forward), mean board watts, GOPS/W, beside the energy model's figures
   for BETA on the ZCU102 and the paper's Table II.  [17d] the four
   ``examples/torch_*.py`` as subprocesses on the card at once (training
   20 steps, the precision trade-off 10 steps a mode), each exiting 0.
18. multi-device QAT training on ``torch.distributed``.  Two ranks share
   the card (spawned processes, gloo, mesh 2x1; gloo takes each CUDA
   tensor's collective through the host, ``runtime/collectives.py``).
   [18a] bit-bert-base W1A1 whole through ``TrainingRunner``, FSDP
   storage, 5 steps of 32 x 128, the checkpoint gathered to rank 0 alone;
   after each step the state is gathered to rank 0, which takes the
   1-rank step from it: every step's loss within ``MD_STEP_LOSS_RTOL``,
   AdamW's first moments within ``MD_MU_RTOL`` of a leaf's largest, under
   ``MD_APART_SHARE`` of the params apart by more than lr / 10 (``MD_*``
   bounds); one rank's rows alone must read beyond ``MD_MU_RTOL``.  [18b]
   granite-8b at full width on 4 of 36 layers with ``prebinarize_gather``,
   2 steps of 4 x 512 against a 1-rank prebinarized run; the bytes the
   gathers bring a rank as packed sign words, as the float32 latents they
   replace and as float leaves.  [18c] ``make_compressed_dp_step`` on
   bit-bert-base, 5 steps, the int8 and the float32 update from one state
   at each step, the next batch's loss of both; the last step's gradients
   all-gathered outside the step: the int8 average within half a
   quantization step of the ranks' mean ``g + e``, the float32 average
   the ranks' mean ``g``, each step's first moments AdamW's on those
   averages; the bytes each step hands to the collectives.  Each part
   logs its seconds and its host-staged gloo seconds by op.  [18d] one
   rank over NCCL: the mesh step bit for bit the step without a process
   group.  [18e] [18a]'s checkpoint packed and one 128-token ``Z.prefill``
   at W1A1 through K3 (72 launches, K3's ``multidevice`` entry), bitwise
   to K3's plain version.
19. the static-analysis and dry-run modules on the card.  [19a] the
   invariant verifier (``analysis/verifier.py``) over every QMM backend
   at W1A8 / W1A1 / A8xA8 with CUDA operands, at (8, 64, 16) and at
   granite-8b's up site (4, 4096, 14336); [19b] over granite-8b at full
   width and depth (a 128-token prefill and a decode step, ``pallas`` then
   ``fused``: 252 named ``qlinear`` records a forward, the cache contract)
   and bit-bert-base W1A1 with ``attn.qk -> binary``.  Each run must find
   nothing, and cross each kernel wrapper's boundary exactly as many times
   as the wrapper launched (each kernel's ``verified`` count).  [19c] the
   self-test with CUDA tensors.  [19d] the dry-run's granite-8b
   ``train_4k`` cells on (16, 16) and (2, 16, 16) and the smoke cell; its
   argument bytes for granite-8b on [18b]'s 4 layers at 1x1 against the
   growth of ``torch.cuda.memory_allocated`` when those params and their
   AdamW state are built on the card (within 512 B, the allocator's
   rounding, a tensor), and its 2x1 plan's gathered bytes against [18b]'s
   counters, exactly.
11. (printed last) one JSON line of per-kernel numbers, the ``nvidia-smi``
   line, and last ``{"ok": true, "device": {...}}``.  Each kernel's
   ``launches`` is its wrapper's count over its main path's run alone
   (phase 3's engine run for K1, phase 4's fused pass for K2, phase 5's
   engine run for K3, phase 6 for K4, phase 12's engine run for the scores
   kernel, which adds ``autotune``, [12c]'s keys, timing runs and winners;
   K3 adds ``multidevice``, [18e]'s launches);
   ``replays`` is the number of replayed ticks in that run, and
   ``replay_launches`` the kernel's launches counted on the device in one
   profiled replay of that path's decode graph (K3 and the scores kernel add
   ``prefill_replay_launches``, of the 128-token prefill graph; each path
   adds ``replay_busy_ms``, that replay's device busy time; each adds
   ``verified``, the boundaries [19a]-[19b]'s walks crossed (equal to its
   launches there); K1 adds
   ``gemma3``, ``deepseek``, ``recurrentgemma``, ``mamba2``, ``internvl2``
   and ``whisper``, the same numbers for phases 7 to 10, and ``robust``,
   phase [13a]'s faulted run with its snapshot and restore numbers; K2
   adds ``demotion``, [13b]'s run; K3 adds ``trained``, [14e]'s
   launches; each QMM kernel adds ``roofline_launches``, its wrapper calls
   in [17a], and the scores kernel ``scores_bench_launches``, in [17b]; K3
   and K1 add ``gops_per_w``, [17c]'s measured numbers at W1A1 and W1A2-A8
   (the energy model's ZCU102 figures stay on the ``[17c]`` lines); ``deepseek`` with
   its ``expert_loop`` rows, ``internvl2`` and ``whisper`` with their
   prefill graph's launches; ``whisper``'s ``launches`` are its
   transcription's).  The whole run took 634.1 s on an H100 80GB HBM3 at
   700 W before phase 14 (phase 12 about 90 s of it, phase 13 81 s), and
   709.5 s with it (phase 7 124.1 s, phase 14 about 100 s); ``run`` logs
   each phase's time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
from collections import Counter
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.qmm_roofline import HBM_BW, PEAK_INT_OPS, rotation_copies  # noqa: E402

# H100 SXM data sheet, kept in one place (``core/qmm_roofline.py``): HBM3
# rate and dense int8 tensor-core rate (700 W part).
PEAK_BYTES_PER_S = HBM_BW
PEAK_INT8_OPS_PER_S = PEAK_INT_OPS
# Hopper publishes no binary (1-bit) tensor-core rate.  An m16n8k256 .b1 mma
# does 8x the operations of an m16n8k32 int8 one and issues at about the same
# rate (phase 2's ``mma_rates``), so K3's peak is taken as 8x the int8 one.
PEAK_B1_OPS_PER_S = 8 * PEAK_INT8_OPS_PER_S
SITES_PER_LAYER = 7  # attn.q/k/v/o, ffn.up/gate/down
BERT_SITES_PER_LAYER = 6  # attn.q/k/v/o, ffn.up/down (no gate: a plain gelu FFN)


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(calls, reps: int) -> float:
    """Mean time of one call as issued from Python, cycling through ``calls``
    (closures on distinct operand copies): CUDA events around ``reps``
    calls after a warm-up pass.  Includes the host's launch cost wherever
    it exceeds the device's work -- what an eager caller pays."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(calls, reps: int) -> float:
    """Mean device time of one call: ``reps`` calls (cycling ``calls``)
    captured once in a CUDA graph and replayed between CUDA events, so no
    host launch cost sits between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int, ops_per_s: float = PEAK_INT8_OPS_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# The route K3 took, kept visible: each ``mma.sync`` product issued back to
# back from registers by every SM (4 blocks of 8 warps an SM, 4 independent
# accumulators a warp), the binary one beside the int8 one.
MMA_RATE_LOOPS = {  # name -> (PTX of one product, operations it counts)
    "b1 m16n8k256 .and.popc": ("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc",
                               2 * 16 * 8 * 256),
    "s8 m16n8k32": ("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32", 2 * 16 * 8 * 32),
}
_MMA_RATE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
#define MMA_LOOP(NAME, PTX)                                                            \
  __global__ void NAME(int* out, int iters) {                                         \
    const uint32_t a0 = threadIdx.x * 0x9E3779B9u, a1 = a0 ^ 0x5555u, a2 = ~a0,     \
                   a3 = a0 * 3u, b0 = a0 >> 3, b1 = a0 * 7u;                         \
    int c[4][4] = {};                                                                 \
    for (int i = 0; i < iters; ++i) {                                                 \
      _Pragma("unroll") for (int j = 0; j < 4; ++j) {                                 \
        asm volatile(PTX " {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"  \
                     : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])     \
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));         \
      }                                                                               \
    }                                                                                 \
    int s = 0;                                                                        \
    for (int j = 0; j < 4; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];           \
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;                                   \
  }
"""


def start_mma_rate_build(build):
    """Write the rate loops' source under ``build/`` and start ``nvcc`` on it
    (beside the kernels' builds); returns ``(library path, process)``."""
    tune = build.BUILD_DIR.parent / "tune"
    tune.mkdir(parents=True, exist_ok=True)
    src, lib = tune / "mma_rate.cu", tune / "libmma_rate.so"
    launches = "\n".join(f"  if (which == {i}) loop{i}<<<blocks, threads, 0, s>>>(out, iters);"
                         for i in range(len(MMA_RATE_LOOPS)))
    src.write_text(_MMA_RATE_SRC + "".join(
        f'MMA_LOOP(loop{i}, "{ptx}")\n' for i, (ptx, _) in enumerate(MMA_RATE_LOOPS.values())
    ) + 'extern "C" int run(int which, int blocks, int threads, int iters, int* out, void* st) {\n'
        "  auto s = static_cast<cudaStream_t>(st);\n" + launches + "\n  return cudaGetLastError();\n}\n")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def mma_rates(job) -> dict:
    """``name -> operations per second`` of each of ``MMA_RATE_LOOPS``."""
    import ctypes

    lib_path, proc = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the mma rate loops:\n{out}")
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.run.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 4096
    buf = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for i, (name, (_, ops)) in enumerate(MMA_RATE_LOOPS.items()):
        for _ in range(2):  # warm-up, then timed
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.run(i, blocks, threads, iters, buf.data_ptr(), stream)
            end.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"mma rate loop {name}: cudaError {err}")
        rates[name] = blocks * threads // 32 * iters * 4 * ops / (start.elapsed_time(end) * 1e-3)
    return rates


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# (M, K, N): decode at the slot count (M=1: one live slot, M=4: the
# engine's batch) and prefill at a 128-token and a ragged 35-token prompt,
# at granite-8b's q/o (4096x4096), k/v (4096x1024), up/gate (4096x14336)
# and down (14336x4096) sites, plus a ragged shape.  The first is the
# headline row of the JSON line.  K1 and K2 run at each.
KERNEL_SHAPES = [
    (4, 4096, 14336),
    (1, 4096, 14336),
    (4, 4096, 4096),
    (4, 4096, 1024),
    (4, 14336, 4096),
    (128, 4096, 14336),
    (128, 14336, 4096),
    (35, 4096, 1024),
    (7, 100, 33),
]
# gemma3-27b's sites at the engine's 4-slot decode: attn.q (5376x4096),
# attn.k/v (5376x2048), attn.o (4096x5376), ffn.up/gate (5376x21504) and
# ffn.down (21504x5376).  K1 and K2 run at each.
GEMMA3_SHAPES = [
    (4, 5376, 4096),
    (4, 5376, 2048),
    (4, 4096, 5376),
    (4, 5376, 21504),
    (4, 21504, 5376),
]
# K1 alone at bit-bert-base's sites, where the W1A2/A4/A8 ladder sends it:
# attn.q/k/v/o (768x768), ffn.up (768x3072) and ffn.down (3072x768) at a
# 128-token prefill and a batch-1 decode; and at gemma3-27b's up site in a
# 128-token prefill.
BERT_K1_SHAPES = [
    (128, 768, 3072),
    (128, 768, 768),
    (128, 3072, 768),
    (1, 768, 3072),
    (1, 768, 768),
    (1, 3072, 768),
]
# deepseek-v2-lite-16b's sites at the engine's 4-slot decode: attn.q
# (2048 -> 16 x 192), attn.kv_down (2048x512), attn.k_rope (2048x64),
# attn.o (2048x2048), the dense layer's ffn.up / gate (2048x10944) and down
# (10944x2048), the shared experts' up / gate (2048x2816) and down
# (2816x2048); and the prefill's attn.k_up / v_up (512 -> 16 x 128) at 128
# tokens.  The routed experts' site is phase 8's expert loop.
DEEPSEEK_SHAPES = [
    (4, 2048, 3072),
    (4, 2048, 512),
    (4, 2048, 64),
    (4, 2048, 2048),
    (4, 2048, 10944),
    (4, 10944, 2048),
    (4, 2048, 2816),
    (4, 2816, 2048),
    (128, 512, 2048),
]
# the recurrent families' sites at the engine's 4-slot decode and a
# 128-token prefill's widest site: recurrentgemma-2b's RG-LRU in_x / in_gate
# / gate_a / gate_i / out and attn.q / o (2560x2560), attn.k / v (2560x256),
# ffn.up / gate (2560x7680) and down (7680x2560); mamba2-130m's in_proj (768
# -> 3352, not a multiple of K1's N tile) and out_proj (1536x768)
RECURRENT_SHAPES = [
    (4, 2560, 2560),
    (4, 2560, 256),
    (4, 2560, 7680),
    (4, 7680, 2560),
    (128, 2560, 7680),
    (4, 768, 3352),
    (4, 1536, 768),
    (128, 768, 3352),
]
# the encoder families' sites: internvl2-2b's attn.q / o (2048x2048), attn.k
# / v (2048x1024), ffn.up / gate (2048x8192) and down (8192x2048) at the
# engine's 4-slot decode, and up / gate in its 320-token image prefill;
# whisper-tiny's cross-attention k / v over a 4-slot tick's 4 x 1,500
# encoder rows (every decode step projects them anew) and its decode
# ffn.up (384x1536) and down (1536x384)
ENCODER_SHAPES = [
    (4, 2048, 2048),
    (4, 2048, 1024),
    (4, 2048, 8192),
    (4, 8192, 2048),
    (320, 2048, 8192),
    (6000, 384, 384),
    (4, 384, 1536),
    (4, 1536, 384),
]
K1_ONLY_SHAPES = (BERT_K1_SHAPES + [(128, 5376, 21504)] + DEEPSEEK_SHAPES + RECURRENT_SHAPES
                  + ENCODER_SHAPES)


def _copies(nbytes: int) -> int:
    return rotation_copies(nbytes, "cuda")


def _library_mm(a_i8: torch.Tensor, b_i8: torch.Tensor):
    """One PyTorch call computing an integer product of the same shape on
    unpacked int8 operands: cuBLASLt's int8 GEMM where it takes the shape,
    else a float32 matmul (exact: every sum stays below 2**24)."""
    m, k = a_i8.shape
    n = b_i8.shape[1]
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        b_cm = b_i8.t().contiguous().t()  # column-major, the int8 GEMM's layout
        return "torch._int_mm (int8, pre-unpacked)", lambda: torch._int_mm(a_i8, b_cm)
    a32, b32 = a_i8.float(), b_i8.float()
    return "torch.matmul (float32, pre-unpacked)", lambda: a32 @ b32


def _bit_row(shape, bits, got, want, ms_calls, plain_fn, nbytes, lib,
             ops_per_s=PEAK_INT8_OPS_PER_S):
    m, k, n = shape
    nb, bb = bound(nbytes, 2 * m * k * n, ops_per_s)
    lib_name, lib_fn = lib
    return dict(
        shape=[m, k, n], bits=list(bits), max_abs_err=int((got - want).abs().max()),
        ms=device_ms(ms_calls, 20 * len(ms_calls)), eager_ms=time_ms(ms_calls, 20 * len(ms_calls)),
        plain_ms=time_ms([plain_fn], 3), bound_ms=nb, bound_by=bb,
        library=lib_name, library_ms=device_ms([lib_fn], 20),
    )


def _log_row(name: str, r) -> None:
    int_mm = f" int_mm_ms={r['int_mm_ms']:.4f} [{r['int_mm']}]" if r.get("int_mm_ms") is not None else ""
    plan = f" tile {r['tile'][0]}x{r['tile'][1]} splits {r['splits']}" if "tile" in r else ""
    k4 = f" bitserial_qmm_a1_ms={r['k4_a1_ms']:.4f}" if "k4_a1_ms" in r else ""
    log(f"  {name:13s} {str(tuple(r['shape'])):18s} bits {r['bits']}{plan} equal "
        f"ms={r['ms']:.4f} eager_ms={r['eager_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
        f"({r['bound_by']}) plain_ms={r['plain_ms']:.3f} library_ms={r['library_ms']:.4f} "
        f"[{r['library']}]{int_mm}{k4}")


def check_kernels(gen: torch.Generator):
    from repro_torch.core import packing
    from repro_torch.kernels import ref
    from repro_torch.kernels.binary_qmm import binary_qmm, plan
    from repro_torch.kernels.fused_qmm import fused_qmm

    dev = gen.device
    rows = {"binary_qmm": [], "fused_qmm": []}
    for m, k, n in KERNEL_SHAPES + GEMMA3_SHAPES + K1_ONLY_SHAPES:
        kw = packing.packed_len(k, 1)
        w_bytes = 4 * kw * n
        reps = _copies(w_bytes)
        a = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        wps = [
            packing.pack_bits(torch.randint(0, 2, (k, n), generator=gen, device=dev), 1, axis=0)
            for _ in range(reps)
        ]
        # ---- K1
        got, want = binary_qmm(a, wps[0], k), ref.binary_qmm_ref(a, wps[0], k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"binary_qmm != plain at {(m, k, n)}")
        w_i8 = packing.unpack_bits(wps[0], 1, k, axis=0, dtype=torch.int8)
        lib = _library_mm(a, w_i8)
        if not torch.equal(lib[1]().to(torch.int32), want):
            raise AssertionError(f"{lib[0]} disagrees with binary_qmm_ref at {(m, k, n)}")
        rows["binary_qmm"].append(_bit_row(
            (m, k, n), (8, 1), got, want, [lambda w=w: binary_qmm(a, w, k) for w in wps],
            lambda: ref.binary_qmm_ref(a, wps[0], k), m * k + w_bytes + 4 * m * n, lib))
        bm, bn, splits = plan(m, k, n, dev)
        rows["binary_qmm"][-1].update(tile=[bm, bn], splits=splits)
        _log_row("binary_qmm", rows["binary_qmm"][-1])
        if (m, k, n) in K1_ONLY_SHAPES:
            del wps, a
            continue
        # ---- K2 at W1A8: 8 activation planes x 1 weight plane, arbitrary scales
        x = torch.randint(0, 256, (m, k), generator=gen, device=dev)
        ap = packing.pack_bitplanes(x, 8, axis=-1)
        coeffs = [torch.randn(s, generator=gen, device=dev) for s in ((m, 1), (m, 1), (1, n), (1, n))]
        got = fused_qmm(ap, wps[0][None], *coeffs, k)
        want = ref.fused_qmm_ref(ap, wps[0][None], *coeffs, k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fused_qmm not bitwise equal to plain at {(m, k, n)}: "
                                 f"max |diff| {(got - want).abs().max().item()}")
        xd = x.float() * coeffs[0] + coeffs[1]
        wd = w_i8.float() * coeffs[2] + coeffs[3]
        nb, bb = bound(4 * (8 * m * kw + kw * n) + 8 * (m + n) + 4 * m * n, 2 * m * k * n)
        # second yardstick where the int8 GEMM takes the shape: the same
        # integer core X @ W on the re-centered int8 operands K1's row uses
        int_mm = int_mm_ms = None
        if m > 16:
            xc = (x - 128).to(torch.int8)
            int_mm, int_mm_fn = _library_mm(xc, w_i8)
            back = int_mm_fn().to(torch.int64) + 128 * w_i8.sum(0, keepdim=True, dtype=torch.int64)
            if not torch.equal(back, (x.double() @ w_i8.double()).to(torch.int64)):
                raise AssertionError(f"{int_mm} disagrees with the integer core at {(m, k, n)}")
            int_mm_ms = device_ms([int_mm_fn], 20)
        rows["fused_qmm"].append(dict(
            shape=[m, k, n], bits=[8, 1], max_abs_err=float((got - want).abs().max()),
            ms=device_ms([lambda w=w: fused_qmm(ap, w[None], *coeffs, k) for w in wps], 10 * reps),
            eager_ms=time_ms([lambda w=w: fused_qmm(ap, w[None], *coeffs, k) for w in wps], 10 * reps),
            plain_ms=time_ms([lambda: ref.fused_qmm_ref(ap, wps[0][None], *coeffs, k)], 3),
            bound_ms=nb, bound_by=bb,
            library="torch.matmul (float32, pre-dequantized operands)",
            library_ms=device_ms([lambda: xd @ wd], 20),
            int_mm=int_mm, int_mm_ms=int_mm_ms,
        ))
        _log_row("fused_qmm", rows["fused_qmm"][-1])
        del wps, a, x, ap, xd, wd
        torch.cuda.empty_cache()
    return rows


# K3 at bit-bert-base's sites -- attn.q/k/v/o (768x768), ffn.up (768x3072),
# ffn.down (3072x768) -- at a 128-token prefill (MNLI's length) and a 4-slot
# decode, plus a ragged shape.  The first is the headline row.
POPCOUNT_SHAPES = [
    (128, 768, 3072),
    (128, 768, 768),
    (128, 3072, 768),
    (4, 768, 3072),
    (4, 768, 768),
    (4, 3072, 768),
    (7, 100, 33),
]
# K4: BERT-base's per-head Q.K^T (d_head 64 over 128 tokens) at A4xA4 and
# A8xA8, the FFN up shape at A4xA4, A8xA8 and A2xA2 (the tensor-core
# kernel's time should not follow the bit widths), and ragged shapes.
BITSERIAL_CASES = [
    ((128, 64, 128), 4, 4),
    ((128, 64, 128), 8, 8),
    ((128, 768, 3072), 4, 4),
    ((128, 768, 3072), 8, 8),
    ((128, 768, 3072), 2, 2),
    ((7, 100, 33), 4, 4),
    ((7, 100, 33), 1, 4),
]


def check_bit_kernels(gen: torch.Generator):
    """K3 and K4 against their plain versions (equal int32), timed."""
    from repro_torch.core import packing
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitserial_qmm import bitserial_qmm
    from repro_torch.kernels.popcount_qmm import plan as popcount_plan
    from repro_torch.kernels.popcount_qmm import popcount_qmm

    dev = gen.device
    rows = {"popcount_qmm": [], "bitserial_qmm": []}
    for m, k, n in POPCOUNT_SHAPES:
        kw = packing.packed_len(k, 1)
        a = torch.randint(0, 2, (m, k), generator=gen, device=dev, dtype=torch.int8)
        ap = packing.pack_bits(a, 1, axis=-1)
        b = torch.randint(0, 2, (k, n), generator=gen, device=dev, dtype=torch.int8)
        bps = [packing.pack_bits(b, 1, axis=0)] + [
            packing.pack_bits(torch.randint(0, 2, (k, n), generator=gen, device=dev), 1, axis=0)
            for _ in range(_copies(4 * kw * n) - 1)
        ]
        got, want = popcount_qmm(ap, bps[0]), ref.popcount_qmm_ref(ap, bps[0], k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"popcount_qmm != plain at {(m, k, n)}")
        lib = _library_mm(a, b)
        if not torch.equal(lib[1]().to(torch.int32), want):
            raise AssertionError(f"{lib[0]} disagrees with popcount_qmm_ref at {(m, k, n)}")
        rows["popcount_qmm"].append(_bit_row(
            (m, k, n), (1, 1), got, want, [lambda w=w: popcount_qmm(ap, w) for w in bps],
            lambda: ref.popcount_qmm_ref(ap, bps[0], k), 4 * (m * kw + kw * n) + 4 * m * n, lib,
            PEAK_B1_OPS_PER_S))
        # K4 at A1xA1 computes the same sum on the same layout (the u8
        # tensor-core route K3 did not take); timed beside K3 to keep it visible
        if not torch.equal(bitserial_qmm(ap[None], bps[0][None]), want):
            raise AssertionError(f"bitserial_qmm A1xA1 != popcount_qmm_ref at {(m, k, n)}")
        bm, bn, splits = popcount_plan(m, k, n, dev)
        rows["popcount_qmm"][-1].update(tile=[bm, bn], splits=splits, k4_a1_ms=device_ms(
            [lambda w=w: bitserial_qmm(ap[None], w[None]) for w in bps], 20 * len(bps)))
        del bps, a, b
    for (m, k, n), xb, yb in BITSERIAL_CASES:
        kw = packing.packed_len(k, 1)
        x = torch.randint(0, 2**xb, (m, k), generator=gen, device=dev)
        y = torch.randint(0, 2**yb, (k, n), generator=gen, device=dev)
        ap = packing.pack_bitplanes(x, xb, axis=-1)
        bps = [packing.pack_bitplanes(y, yb, axis=-2)] + [
            packing.pack_bitplanes(torch.randint(0, 2**yb, (k, n), generator=gen, device=dev), yb, axis=-2)
            for _ in range(_copies(4 * yb * kw * n) - 1)
        ]
        got, want = bitserial_qmm(ap, bps[0]), ref.bitserial_qmm_ref(ap, bps[0], k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"bitserial_qmm != plain at {(m, k, n)} A{xb}xA{yb}")
        # the library call multiplies the re-centered int8 mantissas; the
        # affine identity brings its result back to the unsigned product
        cx, cy = 2 ** (xb - 1) if xb > 1 else 0, 2 ** (yb - 1) if yb > 1 else 0
        xc, yc = (x - cx).to(torch.int8), (y - cy).to(torch.int8)
        lib = _library_mm(xc, yc)
        back = (lib[1]().to(torch.int64) + cy * xc.sum(-1, keepdim=True, dtype=torch.int64)
                + cx * yc.sum(0, keepdim=True, dtype=torch.int64) + cx * cy * k)
        if not torch.equal(back.to(torch.int32), want):
            raise AssertionError(f"{lib[0]} disagrees with bitserial_qmm_ref at {(m, k, n)}")
        rows["bitserial_qmm"].append(_bit_row(
            (m, k, n), (xb, yb), got, want, [lambda w=w: bitserial_qmm(ap, w) for w in bps],
            lambda: ref.bitserial_qmm_ref(ap, bps[0], k),
            4 * (xb * m * kw + yb * kw * n) + 4 * m * n, lib))
        del bps, x, y
    for name, shapes in rows.items():
        for r in shapes:
            _log_row(name, r)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3/4: the main path
# ---------------------------------------------------------------------------


def with_backend(cfg, backend: str):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend=backend))


def make_requests(Request, vocab: int, n: int = 8, seed: int = 0, lo: int = 32, hi: int = 128):
    rng = np.random.default_rng(seed)
    temps = [0.0] * (n - 2) + [0.8, 0.8]
    return [
        Request(
            prompt=rng.integers(0, vocab, size=(int(rng.integers(lo, hi + 1)),)).astype(np.int64),
            max_new_tokens=16,
            temperature=t,
        )
        for t in temps
    ]


def greedy_steps(Z, cfg, params, prompt, n_decode: int, device, tokens=None, frontend=None):
    """Prefill ``prompt`` (with ``frontend``, where given) then ``n_decode``
    decode steps at batch 1; feeds ``tokens`` when given (teacher
    forcing), else its own greedy choices.  Returns (logits per step,
    tokens fed)."""
    cache = Z.init_cache(1, 512, cfg, device=device)
    logits, cache = Z.prefill(params, torch.as_tensor(prompt[None], device=device), cfg, cache, frontend)
    out, fed = [logits.float().cpu()], []
    for i in range(n_decode):
        tok = int(out[-1].argmax()) if tokens is None else tokens[i]
        fed.append(tok)
        logits, cache = Z.decode_step(params, torch.tensor([tok], device=device), cfg, cache)
        out.append(logits.float().cpu())
    return out, fed


KERNEL_NAMES = ("binary_qmm", "fused_qmm", "popcount_qmm", "bitserial_qmm", "binary_attn_scores_planes")


# The trace drops the device operations of a window's first moments, and
# more of them the longer the process has run: by phase 10 it lost the
# first ~0.5 ms, 26 operations of an eager tick, 248 of a replayed prefill
# (measured with spin kernels, ``torch.cuda._sleep``, at both edges of the
# window: those at the start went, those at the end stayed).  So each
# profile opens with PROFILE_MARGIN spin kernels and PROFILE_MARGIN_S of
# idle time before the work, closes with PROFILE_MARGIN spin kernels, and
# counts neither; a trace that lost some of them is logged.
PROFILE_MARGIN = 64
PROFILE_MARGIN_S = 0.05
_MARGIN_NAME = "spin_kernel"


def _spin_kernels() -> None:
    for _ in range(PROFILE_MARGIN):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def profile_forward(fn):
    """Run ``fn`` once under ``torch.profiler`` (CPU + CUDA activities).
    Returns (wall ms, device-busy ms, device operations, {kernel: device
    ms}, {kernel: launches}, device span ms) summed over the CUDA events
    (kernels, memsets and copies, whether launched one by one or by a graph
    replay); the span runs from the first device operation's start to the
    last one's end (None where the trace gives no device timestamps).  The
    margins before and after ``fn`` are not counted (``PROFILE_MARGIN``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _spin_kernels()
        time.sleep(PROFILE_MARGIN_S)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        _spin_kernels()
    by_kernel, counts = {}, {}
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spins = sorted(e.time_range.start for e in cuda if _MARGIN_NAME in e.name)
    work = [e for e in cuda if _MARGIN_NAME not in e.name]
    if len(spins) != 2 * PROFILE_MARGIN:
        first = min((e.time_range.start for e in work), default=None)
        before = sum(x < first for x in spins) if first is not None else 0
        log(f"  (the trace holds {len(spins)} of the profile's {2 * PROFILE_MARGIN} margin spin "
            f"kernels, {before} of them before the work)")
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and _MARGIN_NAME not in e.key:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + e.self_device_time_total / 1e3
            counts[e.key] = counts.get(e.key, 0) + e.count
    ranges = [(e.time_range.start, e.time_range.end) for e in work]
    span = (max(r[1] for r in ranges) - min(r[0] for r in ranges)) / 1e3 if ranges else None
    return wall, sum(by_kernel.values()), sum(counts.values()), by_kernel, counts, span


def ours(by_kernel) -> dict:
    """Per port kernel, the sum over the profiler's names that contain it."""
    return {name: sum(v for k, v in by_kernel.items() if name in k) for name in KERNEL_NAMES}


def report_profile(tag: str, wall, busy, launches, by_kernel, counts, span, phase: int = 3,
                   wall_ms=None) -> None:
    """Log one profile; with ``wall_ms`` (the same step timed without the
    profiler, which stretches wall time) the idle share is read against it.
    The device span minus busy is the card's own idle time between the
    step's operations; wall minus span is the host's part."""
    wall_ms = wall if wall_ms is None else wall_ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    gaps = "not measured" if span is None else f"{span:.2f} ms (gaps {span - busy:.2f} ms)"
    log(f"[{phase}] profile {tag}: wall {wall_ms:.2f} ms (profiled {wall:.2f}), device busy "
        f"{busy:.2f} ms (idle share {1 - busy / wall_ms:.3f}), device span {gaps}, {launches} "
        f"device operations; "
        + ", ".join(f"{name} {ms:.3f} ms x {ours(counts)[name]}" for name, ms in ours(by_kernel).items()))
    log(f"[{phase}]   top kernels: " + "; ".join(f"{k[:60]} {ms:.3f} ms" for k, ms in top))


# ---------------------------------------------------------------------------
# phases 3-5: the compiled steps (CUDA graphs) against the eager ones
# ---------------------------------------------------------------------------


REPLAY_REPS = 20  # compiled calls (and as many bare replays) timed per step


def wall_ms(fn, reps: int = 5, setup=lambda: None) -> float:
    """Median host time of ``fn(setup())`` over ``reps`` calls, each
    synchronised; ``setup`` runs before each call, untimed."""
    times = []
    for _ in range(reps):
        arg = setup()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def replay_times(call, step, reps: int = 20, setup=lambda: None):
    """Medians over ``reps`` alternating pairs (``setup`` untimed before
    each): the host wall of ``call()``, synchronised -- a compiled step's
    whole call -- and the device span of a bare ``step.graph.replay()``
    between CUDA events, with the host time its launch took.  Wall minus
    span is the host's work around the replay (checking the captured
    tensors, the token copy, the logits clone)."""
    walls, spans, launch = [], [], []
    for _ in range(reps):
        setup()
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t = time.perf_counter()
        step.graph.replay()
        launch.append((time.perf_counter() - t) * 1e3)
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    return float(np.median(walls)), float(np.median(spans)), float(np.median(launch))


def check_us(step, params, cache, reps: int = 50) -> float:
    """Median host time, in microseconds, of the check every compiled call
    makes before it replays: are these the captured tensors?"""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        if not step.captured_on(params, cache):
            raise AssertionError("the compiled step does not recognise its captured tensors")
        times.append((time.perf_counter() - t) * 1e6)
    return float(np.median(times))


def pool_bytes(graph):
    """(reserved, allocated) bytes of ``graph``'s private memory pool: the
    segments ``torch.cuda.memory_snapshot()`` files under its pool id.  None
    where the snapshot names no pools."""
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in s for s in segments):
        return None
    mine = [s for s in segments if tuple(s["segment_pool_id"]) == tuple(graph.pool())]
    return sum(s["total_size"] for s in mine), sum(s["allocated_size"] for s in mine)


def log_capture(phase: int, tag: str, step, ms: float) -> None:
    pool = pool_bytes(step.graph)
    mem = "not measured" if pool is None else f"{pool[0] / 1e9:.3f} GB reserved, {pool[1] / 1e9:.3f} GB in use"
    log(f"[{phase}] {tag} capture: {ms:.1f} ms (warm-up run included); the graph's memory pool {mem}")


def graph_vs_eager(Z, make_decode_step, cfg, params, cache, max_len: int, tokens, kernel,
                   per_forward: int, phase: int, tag: str, n_ticks: int = 5) -> int:
    """From two copies of a filled packed ``cache`` (made for ``max_len``
    positions: a ring layer holds fewer rows): ``n_ticks`` eager decode
    ticks beside ``n_ticks`` calls of a compiled step (one capture, then
    replays), logits and every cache leaf held bitwise equal at each tick;
    then the eager and the replayed tick timed (host clock, synchronised)
    and each profiled once.  The capturing call goes through ``kernel``'s
    wrapper 2 x ``per_forward`` times (warm-up run, capture) and a replay
    not at all; the profiled replay must run ``kernel`` ``per_forward``
    times on the device.  Returns that device count and the replay's
    device busy ms (``replay_launches``, ``replay_busy_ms``)."""
    eager, graphed = Z.cache_copy(cache), Z.cache_copy(cache)
    step = make_decode_step(cfg, tokens.shape[0], max_len, device=tokens.device)
    tok, calls = tokens, []
    for i in range(n_ticks):
        want, _ = Z.decode_step(params, tok, cfg, eager)
        before = kernel.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, _ = step(params, tok, graphed)
        torch.cuda.synchronize()
        if i == 0:
            capture_ms = (time.perf_counter() - t) * 1e3
        calls.append(kernel.launches - before)
        if not torch.equal(got, want) or not Z.caches_equal(graphed, eager):
            raise AssertionError(f"{tag}: replayed tick {i} not bitwise equal to the eager tick")
        tok = want.argmax(-1)
    if (step.captures, step.replays) != (1, n_ticks - 1) or calls != [2 * per_forward] + [0] * (n_ticks - 1):
        raise AssertionError(f"{tag}: {step.captures} captures, {step.replays} replays, "
                             f"{kernel.__name__} wrapper calls per compiled call {calls}")
    log(f"[{phase}] {tag}: {n_ticks} ticks (1 capture + {n_ticks - 1} replays) bitwise equal to the "
        f"eager step, logits and every cache leaf; {kernel.__name__} wrapper calls per compiled "
        f"call {calls} (warm-up run + capture, then replays, which call no wrapper)")
    log_capture(phase, tag, step, capture_ms)
    eager_ms = wall_ms(lambda _: Z.decode_step(params, tok, cfg, eager))
    replay_ms, span, launch = replay_times(lambda: step(params, tok, graphed), step, reps=REPLAY_REPS)
    check = check_us(step, params, graphed)
    report_profile(f"{tag} eager tick", *profile_forward(lambda: Z.decode_step(params, tok, cfg, eager)),
                   phase=phase, wall_ms=eager_ms)
    prof = profile_forward(lambda: step(params, tok, graphed))
    report_profile(f"{tag} replayed tick", *prof, phase=phase, wall_ms=replay_ms)
    on_device = ours(prof[4])[kernel.__name__]
    if on_device != per_forward:
        raise AssertionError(f"{tag}: the profiled replay ran {kernel.__name__} {on_device} times, "
                             f"expected {per_forward}")
    log(f"[{phase}] {tag}: tick wall eager {eager_ms:.2f} ms, replayed {replay_ms:.2f} ms "
        f"({eager_ms / replay_ms:.1f}x); a bare graph replay spans {span:.2f} ms between CUDA events "
        f"(its launch {launch:.2f} ms of host time); the captured-tensor check {check:.0f} us of host "
        f"time a call; {kernel.__name__} {on_device} times in the profiled replay")
    del step, eager, graphed
    torch.cuda.empty_cache()
    return dict(replay_launches=on_device, replay_busy_ms=prof[1])


def fill_cache(Z, cfg, params, prompts, device, max_len: int = 512):
    """A packed cache with one row per prompt, each prefilled eagerly."""
    cache = Z.init_cache(len(prompts), max_len, cfg, device=device)
    for i, prompt in enumerate(prompts):
        slot = Z.init_slot_cache(max_len, cfg, device=device)
        Z.prefill(params, torch.as_tensor(np.asarray(prompt)[None], device=device), cfg, slot)
        Z.cache_insert(cache, slot, i)
    return cache


def engine_counts(engine, kernels, launched, per_forward: int, main, phase: int,
                  prefill_per_forward=None, also=()) -> None:
    """Check the engine run's wrapper launches ``launched`` (counts zeroed
    just before the run, read just after): ``main`` ``prefill_per_forward``
    (default ``per_forward``) times for each eager prefill and twice
    ``per_forward`` for the capturing tick (warm-up run, capture), each
    ``(kernel, per_forward)`` of ``also`` likewise, every other kernel
    never; log the ticks."""
    step = engine.decode_fn
    events = engine.last_events
    prefills = sum(e["kind"] == "prefill" for e in events)
    compiles = [e["ms"] for e in events if e["kind"] == "compile"]
    ticks = [e["ms"] for e in events if e["kind"] == "decode_tick"]
    pre = per_forward if prefill_per_forward is None else prefill_per_forward
    got = {k.__name__: n for k, n in zip(kernels, launched)}
    want = {k.__name__: pre * prefills + per_forward * 2 * len(compiles) if k is main else 0
            for k in kernels}
    for k, n in also:
        want[k.__name__] = n * prefills + n * 2 * len(compiles)
    if got != want or len(compiles) != 1 or step.captures != 1 or step.replays != len(ticks):
        raise AssertionError(f"engine launches {got}, expected {want}; {len(compiles)} capturing "
                             f"ticks, {step.captures} captures, {step.replays} replays, {len(ticks)} ticks")
    for k, n, p in [(main, per_forward, pre)] + [(k, n, n) for k, n in also]:
        log(f"[{phase}] {k.__name__} launches {got[k.__name__]} = {p} x {prefills} eager "
            f"prefills + {n} x 2 for the capturing tick (warm-up run and capture)")
    log(f"[{phase}] the other kernels 0; {len(ticks)} replayed ticks ran the captured step, which "
        "calls no wrapper")
    log_capture(phase, "engine decode step", step, compiles[0])
    log(f"[{phase}] replayed decode tick ms (4 slots, synchronised, logits copy to the host "
        f"excluded): median {np.median(ticks):.2f} mean {np.mean(ticks):.2f} min {np.min(ticks):.2f}")


# ---------------------------------------------------------------------------
# phase 5: bit-bert-base W1A1 (K3) and its precision ladder (K1)
# ---------------------------------------------------------------------------


def _zero(kernels) -> None:
    for k in kernels:
        k.launches = 0


def _counts(kernels):
    return [k.launches for k in kernels]


def serve_bitbert(Z, cfg_a1, device, Request, ServeEngine, serve_sequential, make_decode_step,
                  make_prefill, ops, ref, kernels) -> dict:
    """Serve bit-bert-base at full width through the engine, hold its
    compiled decode step and 128-token prefill to the eager ones; returns
    K3's numbers for the JSON line: its wrapper launches in the engine run,
    the run's replayed ticks, and its device launches in a profiled replay
    of the decode and of the prefill graph."""
    from repro_torch.configs import get_config

    cfg = with_backend(cfg_a1, "pallas")
    per_forward = BERT_SITES_PER_LAYER * cfg.n_layers
    t = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)
    torch.cuda.synchronize()
    log(f"[5] {cfg.name} (W1A{cfg.quant.act_bits}): {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, learned positions over {cfg.max_seq}, "
        f"causal={cfg.causal}; serving params built on the card in {time.perf_counter() - t:.1f} s")

    def requests(n=8, seed=0):
        return make_requests(Request, n=n, seed=seed, vocab=cfg.vocab_size, lo=64, hi=128)

    ServeEngine(cfg, params, batch_slots=4, max_len=512, seed=0, device=device).run(requests(n=2, seed=1))
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=512, seed=0, device=device)
    torch.cuda.synchronize()
    reqs = requests()
    _zero(kernels)
    t = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = _counts(kernels)
    if not all(r.state == "ok" and len(r.output) == 16 for r in done):
        raise AssertionError(f"bit-bert requests not ok: {[(r.state, len(r.output)) for r in done]}")
    prefill_ms = [e["ms"] for e in engine.last_events if e["kind"] == "prefill"]
    n_tok = sum(len(r.output) for r in done)
    plens = [len(r.prompt) for r in done]
    log(f"[5] served {len(done)} requests (prompts {min(plens)}-{max(plens)} tokens, 16 new each, "
        f"6 greedy + 2 at T=0.8) in {wall:.2f} s: {n_tok / wall:.1f} generated tokens/s end to end; "
        f"eager exact-length prefills {sum(prefill_ms) / 1e3:.2f} s of it")
    engine_counts(engine, kernels, launched, per_forward, kernels[2], phase=5)
    path = dict(launches=launched[2], replays=engine.decode_fn.replays)
    log(f"[5] prefill ms: mean {np.mean(prefill_ms):.1f} (per prompt: "
        + ", ".join(f"{p}:{ms:.1f}" for p, ms in zip(plens, prefill_ms)) + ")")
    del engine

    seq = serve_sequential(cfg, params, requests(), max_len=512, seed=0, device=device)
    for got, want in zip(done, seq):
        if got.temperature == 0 and got.output != want.output:
            raise AssertionError(f"bit-bert engine greedy tokens {got.output} != sequential {want.output}")
    sampled_same = sum(g.output == w.output for g, w in zip(done, seq) if g.temperature > 0)
    log(f"[5] engine greedy tokens equal serve_sequential for all 6 greedy requests "
        f"(sampled requests equal: {sampled_same}/2)")

    cache = fill_cache(Z, cfg, params, [r.prompt for r in done[:4]], device)
    step = torch.tensor([r.output[0] for r in done[:4]], device=device)
    path.update(graph_vs_eager(Z, make_decode_step, cfg, params, cache, 512, step, kernels[2],
                               per_forward, phase=5, tag="W1A1 decode tick (4 slots)"))
    del cache
    path["prefill_replay_launches"] = compiled_prefill(Z, make_prefill, cfg, params, kernels[2],
                                                     per_forward, device)

    long = max(done, key=lambda r: len(r.prompt))
    prompt = np.asarray(long.prompt)
    kern, fed = greedy_steps(Z, cfg, params, prompt, 1, device)
    plain = lambda a, b: ref.popcount_qmm_ref(a, b, 32 * a.shape[1])  # noqa: E731
    with mock.patch.object(ops._pq, "popcount_qmm", plain):
        plain_out, _ = greedy_steps(Z, cfg, params, prompt, 1, device, tokens=fed)
    if not all(torch.equal(a, b) for a, b in zip(kern, plain_out)):
        raise AssertionError("bit-bert logits differ with K3 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in kern):
        raise AssertionError("bit-bert logits not finite or of the wrong shape")
    log(f"[5] prefill ({len(prompt)} tokens) + decode logits bitwise equal with popcount_qmm "
        f"swapped for popcount_qmm_ref on the same tensors")

    # the precision ladder: the same weights (binarization does not depend on
    # the activation precision, so init_serving_params(0, ...) would draw and
    # pack exactly these), W1A2 / A4 / A8 activations, all through K1
    for name in ("bit-bert-base-a2", "bit-bert-base-a4", "bit-bert-base-a8"):
        lcfg = with_backend(get_config(name), "pallas")
        greedy_steps(Z, lcfg, params, prompt, 1, device)  # warm-up
        torch.cuda.synchronize()
        _zero(kernels)
        cache = Z.init_cache(1, 512, lcfg, device=device)
        t = time.perf_counter()
        logits, cache = Z.prefill(params, torch.as_tensor(prompt[None], device=device), lcfg, cache)
        torch.cuda.synchronize()
        t_pre = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        logits2, cache = Z.decode_step(params, logits.argmax(-1), lcfg, cache)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t) * 1e3
        k1, k2, k3, k4 = _counts(kernels)
        if (k2, k3, k4) != (0, 0, 0) or k1 != 2 * per_forward:
            raise AssertionError(f"{name} launches K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4}; expected K1 = "
                                 f"{per_forward} x 2 forwards and no other")
        if not all(bool(torch.isfinite(x).all()) and x.shape == (1, lcfg.vocab_size) for x in (logits, logits2)):
            raise AssertionError(f"{name} logits not finite or of the wrong shape")
        # the same prefill and decode step with K1 swapped for its plain
        # version: every K1 call at this ladder's own shapes, held bitwise
        with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
            plain_out, _ = greedy_steps(Z, lcfg, params, prompt, 1, device,
                                        tokens=[int(logits.argmax())])
        if not (torch.equal(logits.float().cpu(), plain_out[0]) and torch.equal(logits2.float().cpu(), plain_out[1])):
            raise AssertionError(f"{name} logits differ with K1 swapped for its plain version")
        log(f"[5] {name} (W1A{lcfg.quant.act_bits}): prefill ({len(prompt)} tokens) {t_pre:.1f} ms, "
            f"decode step (batch 1) {t_dec:.1f} ms; binary_qmm launches {k1} = {per_forward} x 2 forwards; "
            f"logits bitwise equal with binary_qmm swapped for binary_qmm_ref")
    del params, cache
    torch.cuda.empty_cache()
    return path


def compiled_prefill(Z, make_prefill, cfg, params, kernel, per_forward: int, device,
                     prompt_len: int = 128, batch: int = 1, max_len: int = 512, frontends=None,
                     phase: int = 5, tag: str = "") -> int:
    """One ``prompt_len``-token forward of ``batch`` rows (bit-bert's is the
    paper's metric): ``make_prefill`` (one capture, then replays on the
    same cache, reset between them) against the eager prefill of the same
    tokens, logits and cache bitwise equal; both timed and profiled.
    ``frontends``, where the model takes one, holds a frontend for each of
    the three calls (capture, two replays), each call held to the eager
    prefill on its own.  The capturing call goes through ``kernel``'s
    wrapper 2 x ``per_forward`` times, a replay not at all.  Returns
    ``kernel``'s device launches in the profiled replay."""
    tag = tag or f"{prompt_len}-token prefill"
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, size=(batch, prompt_len)))
    fn = make_prefill(cfg, batch, prompt_len, max_len, device=device)
    cache = Z.init_cache(batch, max_len, cfg, device=device)

    def extra(i):
        return () if frontends is None else (frontends[i],)

    def fresh():  # an empty cache for the eager prefill, reset in place for the compiled one
        for row in range(batch):
            Z.cache_reset(cache, row, cfg, max_len)
        return Z.init_cache(batch, max_len, cfg, device=device)

    def eager(empty, i=2):
        return Z.prefill(params, tokens.to(device), cfg, empty, *extra(i))

    def compiled(i=2):
        return fn(params, tokens, cache, *extra(i))

    calls = []
    for i in range(3):  # the capture (its warm-up run is the result), then replays
        want, want_cache = eager(fresh(), i)
        before = kernel.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, _ = compiled(i)
        torch.cuda.synchronize()
        if i == 0:
            capture_ms = (time.perf_counter() - t) * 1e3
        calls.append(kernel.launches - before)
        if not torch.equal(got, want) or not Z.caches_equal(cache, want_cache):
            raise AssertionError(f"{tag}: make_prefill call {i} not bitwise equal to the eager prefill")
    if not bool(torch.isfinite(got).all()) or got.shape != (batch, cfg.vocab_size):
        raise AssertionError(f"{tag}: compiled prefill logits not finite or of the wrong shape")
    if (fn.captures, fn.replays) != (1, 2) or calls != [2 * per_forward, 0, 0]:
        raise AssertionError(f"{tag}: make_prefill {fn.captures} captures, {fn.replays} replays, "
                             f"{kernel.__name__} wrapper calls per call {calls}")
    inputs = "tokens" if frontends is None else "tokens, each call its own frontend"
    log(f"[{phase}] {tag} through make_prefill: 1 capture + 2 replays, logits and cache bitwise equal "
        f"to the eager prefill of the same {inputs}; {kernel.__name__} wrapper calls per call {calls}")
    log_capture(phase, tag, fn, capture_ms)
    eager_ms = wall_ms(eager, setup=fresh)
    replay_ms, span, launch = replay_times(lambda: compiled(), fn, reps=REPLAY_REPS, setup=fresh)
    empty = fresh()
    report_profile(f"{tag}, eager", *profile_forward(lambda: eager(empty)), phase=phase, wall_ms=eager_ms)
    fresh()
    prof = profile_forward(lambda: compiled())
    report_profile(f"{tag}, replayed", *prof, phase=phase, wall_ms=replay_ms)
    on_device = ours(prof[4])[kernel.__name__]
    if on_device != per_forward:
        raise AssertionError(f"{tag}: {kernel.__name__} {on_device} times in the profiled replay, "
                             f"expected {per_forward}")
    log(f"[{phase}] {tag} wall: eager {eager_ms:.2f} ms, replayed {replay_ms:.2f} ms "
        f"(x{eager_ms / replay_ms:.1f}; cache set up outside the timed call); a bare graph replay "
        f"spans {span:.2f} ms on the card (its launch {launch:.2f} ms of host time), device busy "
        f"{prof[1]:.2f} ms; {kernel.__name__} {on_device} times in the profiled replay")
    del fn, cache
    torch.cuda.empty_cache()
    return on_device


# ---------------------------------------------------------------------------
# phase 6: the QMM engine's act x act mode (K4)
# ---------------------------------------------------------------------------

# (M, K, N, bits): BERT-base's per-head Q.K^T (128 tokens, d_head 64) at
# A4xA4 and A8xA8, and its FFN up shape at A4xA4
ACT_ACT_CASES = [(128, 64, 128, 4), (128, 64, 128, 8), (128, 768, 3072, 4)]


def act_act(device, gen, kernels) -> int:
    """``qmm(x, y, backend="pallas")`` on two multi-bit activations; returns
    K4's launches."""
    from repro_torch.core import qmm as QE
    from repro_torch.core import quantization as Q

    ops_ = []
    for m, k, n, bits in ACT_ACT_CASES:
        x = torch.randn((m, k), generator=gen, device=device) * 2
        y = torch.randn((k, n), generator=gen, device=device) * 2
        ops_.append((Q.quantize_activation(x, bits, per_channel_axis=0),
                     Q.quantize_activation(y, bits, per_channel_axis=-1)))
    torch.cuda.synchronize()
    _zero(kernels)
    outs = [QE.qmm(x, y, backend="pallas") for x, y in ops_]
    torch.cuda.synchronize()
    k1, k2, k3, k4 = _counts(kernels)
    if (k1, k2, k3) != (0, 0, 0) or k4 != len(ACT_ACT_CASES):
        raise AssertionError(f"act x act launches K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4}; "
                             f"expected K4 = {len(ACT_ACT_CASES)} and no other")
    for (m, k, n, bits), (x, y), got in zip(ACT_ACT_CASES, ops_, outs):
        want = QE.qmm(x, y, backend="popcount")
        if not torch.equal(got, want):
            raise AssertionError(f"act x act A{bits}xA{bits} {(m, k, n)}: pallas (K4) != popcount backend, "
                                 f"max |diff| {(got - want).abs().max().item()}")
        if not bool(torch.isfinite(got).all()) or got.shape != (m, n):
            raise AssertionError(f"act x act {(m, k, n)}: output not finite or of the wrong shape")
    log(f"[6] act x act qmm(backend='pallas'): bitserial_qmm launches {k4} = one per product; "
        "bitwise equal to qmm(backend='popcount') at "
        + ", ".join(f"A{b}xA{b} {(m, k, n)}" for m, k, n, b in ACT_ACT_CASES))
    return k4


# ---------------------------------------------------------------------------
# phase 7: gemma3-27b -- ring-buffer local layers, qk-norm, a local rope theta
# ---------------------------------------------------------------------------

GEMMA3_MAX_LEN = 2048
# (prompt tokens, temperature): five short prompts, one that wraps the
# 1,024-row ring inside its prefill, one whose decode crosses position
# 1,024, and one of 600 tokens; 6 greedy, 2 at T=0.8
GEMMA3_PROMPTS = [(48, 0.0), (1300, 0.0), (96, 0.0), (1016, 0.0), (600, 0.8), (32, 0.0),
                  (128, 0.8), (64, 0.0)]
# the 4-slot cache graph_vs_eager starts from: two rows cross position
# 1,024 in its 5 ticks, one has wrapped, one is short
GEMMA3_TICK_PROMPTS = (1021, 1023, 1300, 100)


def serve_gemma3(Z, model_cfg, device, Request, ServeEngine, serve_sequential, make_decode_step,
                 ops, ref, kernels, smi: str) -> dict:
    """Serve gemma3-27b at full width (its depth as given) through the engine on the
    ``pallas`` backend (K1 at every site), hold it to ``serve_sequential``
    and its replayed tick to the eager one across the ring's wrap; returns
    K1's numbers on this path: its wrapper launches in the engine run, the
    run's replayed ticks and its device launches in a profiled replay."""
    cfg = with_backend(model_cfg, "pallas")
    k1 = kernels[0]
    max_len = GEMMA3_MAX_LEN
    per_forward = SITES_PER_LAYER * cfg.n_layers
    t = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)
    torch.cuda.synchronize()
    rows = Z.cache_rows(max_len, cfg)
    kinds = "".join(cfg.layer_kinds)
    log(f"[7] {cfg.name}: {cfg.n_layers} layers ({kinds.count('l')} local, window {cfg.window_size}, "
        f"rope {cfg.local_rope_theta:g}; {kinds.count('g')} global, rope {cfg.rope_theta:g}; "
        f"{cfg.prefix_layers} + {cfg.pattern_period} x {cfg.n_periods}), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.d_head}, d_ff {cfg.d_ff} ({cfg.ffn_type}), "
        f"vocab {cfg.vocab_size}, qk_norm={cfg.qk_norm}, tied={cfg.tie_embeddings}; serving params "
        f"built on the card in {time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; at max_len {max_len} the local "
        f"layers' caches are {min(rows)}-row rings, the global layers' {max(rows)} rows | {smi}")

    # K1 against its plain version in a short prefill and a decode step, at
    # max_len 512: there the local layers are clipped (512 rows, masked to
    # the window), the other geometry; also the phase's warm-up
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(40,))
    kern, fed = greedy_steps(Z, cfg, params, prompt, 1, device)
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, _ = greedy_steps(Z, cfg, params, prompt, 1, device, tokens=fed)
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError("gemma3 logits differ with K1 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in kern):
        raise AssertionError("gemma3 logits not finite or of the wrong shape")
    geometry = "clipped" if 512 < cfg.window_size else "ring"
    log(f"[7] prefill ({len(prompt)} tokens) + decode at max_len 512 ({geometry} local layers): logits "
        f"bitwise equal with binary_qmm swapped for binary_qmm_ref on the same tensors")

    def requests():
        rng = np.random.default_rng(0)
        return [Request(prompt=rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int64),
                        max_new_tokens=16, temperature=temp) for n, temp in GEMMA3_PROMPTS]

    engine = ServeEngine(cfg, params, batch_slots=4, max_len=max_len, seed=0, device=device)
    torch.cuda.synchronize()
    _zero(kernels)
    t = time.perf_counter()
    done = engine.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = _counts(kernels)
    if not all(r.state == "ok" and len(r.output) == 16 for r in done):
        raise AssertionError(f"gemma3 requests not ok: {[(r.state, len(r.output)) for r in done]}")
    prefill_ms = [e["ms"] for e in engine.last_events if e["kind"] == "prefill"]
    n_tok = sum(len(r.output) for r in done)
    plens = [len(r.prompt) for r in done]
    log(f"[7] served {len(done)} requests (prompts {sorted(plens)} tokens, 16 new each, 6 greedy + 2 "
        f"at T=0.8, 4 slots, max_len {max_len}) in {wall:.2f} s: {n_tok / wall:.1f} generated tokens/s "
        f"end to end; eager exact-length prefills {sum(prefill_ms) / 1e3:.2f} s of it")
    engine_counts(engine, kernels, launched, per_forward, k1, phase=7)
    path = dict(launches=launched[0], replays=engine.decode_fn.replays)
    log("[7] prefill ms per prompt: " + ", ".join(f"{p}:{ms:.1f}" for p, ms in zip(plens, prefill_ms)))
    del engine
    torch.cuda.empty_cache()
    long = max(done, key=lambda r: len(r.prompt))
    tokens = torch.as_tensor(np.asarray(long.prompt)[None], device=device)
    report_profile(f"eager prefill ({len(long.prompt)} tokens)", *profile_forward(
        lambda: Z.prefill(params, tokens, cfg, Z.init_slot_cache(max_len, cfg, device=device))), phase=7)

    seq = serve_sequential(cfg, params, requests(), max_len=max_len, seed=0, device=device)
    for got, want in zip(done, seq):
        if got.temperature == 0 and got.output != want.output:
            raise AssertionError(f"gemma3 engine greedy tokens ({len(got.prompt)}-token prompt) "
                                 f"{got.output} != sequential {want.output}")
    sampled_same = sum(g.output == w.output for g, w in zip(done, seq) if g.temperature > 0)
    w = cfg.window_size
    greedy = [len(r.prompt) for r in done if r.temperature == 0]
    wraps, crosses = [n for n in greedy if n > w], [n for n in greedy if n <= w < n + 16]
    log(f"[7] engine greedy tokens equal serve_sequential for all 6 greedy requests, among them "
        f"prompts of {wraps} tokens (the {w}-row ring wraps inside their prefill) and {crosses} "
        f"(their decode crosses position {w}) (sampled requests equal: {sampled_same}/2)")
    del seq, done

    rng = np.random.default_rng(9)
    cache = fill_cache(Z, cfg, params, [rng.integers(0, cfg.vocab_size, size=(n,)) for n in GEMMA3_TICK_PROMPTS],
                       device, max_len=max_len)
    step = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(len(GEMMA3_TICK_PROMPTS),))).to(device)
    path.update(graph_vs_eager(
        Z, make_decode_step, cfg, params, cache, max_len, step, k1, per_forward, phase=7,
        tag=f"gemma3 pallas decode tick (4 slots at positions {', '.join(map(str, GEMMA3_TICK_PROMPTS))})"))
    del cache, params
    torch.cuda.empty_cache()
    return path


# ---------------------------------------------------------------------------
# phase 8: deepseek-v2-lite-16b -- multi-head latent attention and the MoE
# ---------------------------------------------------------------------------

DEEPSEEK_MAX_LEN = 2048
# (prompt tokens, temperature): one prompt of 1,500 tokens (176 rows per
# expert in its prefill), seven of 32-128; 6 greedy, 2 at T=0.8
DEEPSEEK_PROMPTS = [(1500, 0.0), (48, 0.0), (96, 0.0), (32, 0.0), (128, 0.0), (64, 0.0),
                    (80, 0.8), (112, 0.8)]
# the 4-slot cache graph_vs_eager starts from
DEEPSEEK_TICK_PROMPTS = (1500, 100, 37, 128)
# the routed experts' K1 loop alone: capacity C at a 4-slot tick (1) and a
# 128-token prefill (15), at the experts' up / gate (2048x1408) and down
# (1408x2048) sites
EXPERT_CASES = [(1, 2048, 1408), (1, 1408, 2048), (15, 2048, 1408), (15, 1408, 2048)]


def k1_per_forward(cfg, prefill: bool) -> int:
    """K1 launches of one MLA + MoE forward: each layer's attn.q (or
    q_down and q_up), kv_down, k_rope and o, plus k_up and v_up in a
    prefill; a dense layer's FFN up / gate / down, or an MoE layer's
    shared experts' 3 and 3 per routed expert (one launch per expert)."""
    attn = (5 if cfg.mla.q_lora_rank else 4) + (2 if prefill else 0)
    moe = (3 if cfg.moe.n_shared else 0) + 3 * cfg.moe.n_routed
    return sum(attn + (moe if kind == "Mm" else 3) for kind in cfg.layer_kinds)


def check_expert_loop(gen: torch.Generator, n_experts: int) -> list:
    """The routed experts' integer product as the MoE runs it on the card
    (``moe._experts_k1``: one K1 launch per expert into its slice of one
    (E, C, N) int32 buffer) against the plain version expert by expert,
    bitwise; timed beside its bound, the plain loop and one batched
    PyTorch product on pre-unpacked operands."""
    from repro_torch.core import packing
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ref
    from repro_torch.models import moe as M

    dev = gen.device
    rows = []
    for c, k, n in EXPERT_CASES:
        kw = packing.packed_len(k, 1)
        w_bytes = 4 * n_experts * kw * n
        a = torch.randint(-128, 128, (n_experts, c, k), generator=gen, device=dev, dtype=torch.int8)
        x = Q.QuantTensor(mantissa=a, scale=torch.ones(()), offset=torch.zeros(()), bits=8)
        ws = []
        for _ in range(_copies(w_bytes)):
            wp = packing.pack_bits(torch.randint(0, 2, (n_experts, k, n), generator=gen, device=dev),
                                   1, axis=1)
            ws.append(Q.QuantTensor(mantissa=wp, scale=torch.ones(()), offset=torch.zeros(()), bits=1,
                                    packed=True, packed_axis=1, length=k))
        got = M._experts_k1(x, ws[0])
        want = torch.stack([ref.binary_qmm_ref(a[i], ws[0].mantissa[i], k) for i in range(n_experts)])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"expert loop != plain at {n_experts} x {(c, k, n)}")
        w_i8 = packing.unpack_bits(ws[0].mantissa, 1, k, axis=1, dtype=torch.int8)
        a32, w32 = a.float(), w_i8.float()
        if not torch.equal(torch.bmm(a32, w32).to(torch.int32), want):
            raise AssertionError(f"torch.bmm disagrees with the plain loop at {(c, k, n)}")
        nb, bb = bound(a.numel() + w_bytes + 4 * n_experts * c * n, 2 * n_experts * c * k * n)
        calls = [lambda w=w: M._experts_k1(x, w) for w in ws]
        rows.append(dict(
            shape=[c, k, n], experts=n_experts, bits=[8, 1], max_abs_err=int((got - want).abs().max()),
            ms=device_ms(calls, 4 * len(calls)), eager_ms=time_ms(calls, 4 * len(calls)),
            plain_ms=time_ms([lambda: [ref.binary_qmm_ref(a[i], ws[0].mantissa[i], k)
                                       for i in range(n_experts)]], 2),
            bound_ms=nb, bound_by=bb, library="torch.bmm (float32, pre-unpacked)",
            library_ms=device_ms([lambda: torch.bmm(a32, w32)], 20),
        ))
        r = rows[-1]
        log(f"[8]   expert loop {n_experts} x {(c, k, n)}: {n_experts} binary_qmm launches equal to the "
            f"plain version, expert by expert; ms={r['ms']:.4f} eager_ms={r['eager_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) plain_ms={r['plain_ms']:.3f} "
            f"library_ms={r['library_ms']:.4f} [{r['library']}]")
        del ws, a, x, w_i8, a32, w32
        torch.cuda.empty_cache()
    return rows


def serve_deepseek(Z, model_cfg, device, Request, ServeEngine, make_decode_step, ops, ref,
                   kernels, smi: str, gen: torch.Generator) -> dict:
    """Serve deepseek-v2-lite-16b at full width (its depth as given) through the
    engine on the ``pallas`` backend (K1 at every binary site, the routed
    experts one launch per expert); hold K1 to its plain version in the
    model and in the expert loop alone, and the replayed tick to the eager
    one.  Returns K1's numbers on this path."""
    cfg = with_backend(model_cfg, "pallas")
    k1 = kernels[0]
    max_len = DEEPSEEK_MAX_LEN
    per_decode, per_prefill = k1_per_forward(cfg, False), k1_per_forward(cfg, True)
    m, e = cfg.mla, cfg.moe
    t = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)
    torch.cuda.synchronize()
    log(f"[8] {cfg.name}: {cfg.n_layers} layers ({cfg.prefix_layers} + {cfg.pattern_period} x "
        f"{cfg.n_periods}), d_model {cfg.d_model}, {cfg.n_heads} heads, MLA kv_lora {m.kv_lora_rank} "
        f"q_lora {m.q_lora_rank} nope {m.qk_nope_dim} rope {m.qk_rope_dim} v {m.v_head_dim}; dense "
        f"d_ff {cfg.d_ff}; MoE {e.n_routed} routed + {e.n_shared} shared experts of {e.d_expert_ff}, "
        f"top-{e.top_k} ({e.router_scoring}), capacity factor {e.capacity_factor}; vocab "
        f"{cfg.vocab_size}, tied={cfg.tie_embeddings}; serving params built on the card in "
        f"{time.perf_counter() - t:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; "
        f"K1 launches a forward: {per_decode} decode, {per_prefill} prefill | {smi}")

    # K1 against its plain version in a short prefill and a decode step
    # (every site, the expert loop included); also the phase's warm-up
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(40,))
    kern, fed = greedy_steps(Z, cfg, params, prompt, 1, device)
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, _ = greedy_steps(Z, cfg, params, prompt, 1, device, tokens=fed)
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError("deepseek logits differ with K1 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in kern):
        raise AssertionError("deepseek logits not finite or of the wrong shape")
    log(f"[8] prefill ({len(prompt)} tokens) + decode: logits bitwise equal with binary_qmm swapped "
        f"for binary_qmm_ref on the same tensors (every site, the {e.n_routed}-expert loops included)")

    expert_rows = check_expert_loop(gen, e.n_routed)

    def requests():
        rng = np.random.default_rng(0)
        return [Request(prompt=rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int64),
                        max_new_tokens=16, temperature=temp) for n, temp in DEEPSEEK_PROMPTS]

    engine = ServeEngine(cfg, params, batch_slots=4, max_len=max_len, seed=0, device=device)
    torch.cuda.synchronize()
    _zero(kernels)
    t = time.perf_counter()
    done = engine.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = _counts(kernels)
    if not all(r.state == "ok" and len(r.output) == 16 for r in done):
        raise AssertionError(f"deepseek requests not ok: {[(r.state, len(r.output)) for r in done]}")
    if not all(0 <= tok < cfg.vocab_size for r in done for tok in r.output):
        raise AssertionError("deepseek tokens outside the vocabulary")
    prefill_ms = [e_["ms"] for e_ in engine.last_events if e_["kind"] == "prefill"]
    n_tok = sum(len(r.output) for r in done)
    plens = [len(r.prompt) for r in done]
    log(f"[8] served {len(done)} requests (prompts {sorted(plens)} tokens, 16 new each, 6 greedy + 2 "
        f"at T=0.8, 4 slots, max_len {max_len}) in {wall:.2f} s: {n_tok / wall:.1f} generated tokens/s "
        f"end to end; eager exact-length prefills {sum(prefill_ms) / 1e3:.2f} s of it.  MoE routing "
        f"depends on the batch (every row of a tick competes for {e.n_routed} x 1 rows of capacity), so "
        f"serve_sequential is no oracle here; the CPU tests hold the engine to the reference's engine")
    engine_counts(engine, kernels, launched, per_decode, k1, phase=8, prefill_per_forward=per_prefill)
    path = dict(launches=launched[0], replays=engine.decode_fn.replays)
    log("[8] prefill ms per prompt: " + ", ".join(f"{p}:{ms:.1f}" for p, ms in zip(plens, prefill_ms)))
    del engine
    torch.cuda.empty_cache()
    long = max(done, key=lambda r: len(r.prompt))
    tokens = torch.as_tensor(np.asarray(long.prompt)[None], device=device)
    report_profile(f"eager prefill ({len(long.prompt)} tokens)", *profile_forward(
        lambda: Z.prefill(params, tokens, cfg, Z.init_slot_cache(max_len, cfg, device=device))), phase=8)
    del done

    rng = np.random.default_rng(9)
    cache = fill_cache(Z, cfg, params, [rng.integers(0, cfg.vocab_size, size=(n,)) for n in DEEPSEEK_TICK_PROMPTS],
                       device, max_len=max_len)
    step = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(len(DEEPSEEK_TICK_PROMPTS),))).to(device)
    path.update(graph_vs_eager(
        Z, make_decode_step, cfg, params, cache, max_len, step, k1, per_decode, phase=8,
        tag=f"deepseek pallas decode tick (4 slots at positions {', '.join(map(str, DEEPSEEK_TICK_PROMPTS))})"))
    path["expert_loop"] = expert_rows
    del cache, params
    torch.cuda.empty_cache()
    return path


# ---------------------------------------------------------------------------
# phase 9: the recurrent families -- recurrentgemma-2b (RG-LRU beside local
# attention) and mamba2-130m (chunked SSD)
# ---------------------------------------------------------------------------

# name -> (max_len, the long prompt, the 4-slot cache graph_vs_eager starts
# from).  recurrentgemma: at max_len 4096 each "l" layer is a 2,048-row
# ring; a 2,100-token prompt wraps it inside its prefill, and the tick's
# 2,046-token row crosses position 2,048.  mamba2: 1,000 tokens are 8
# chunks of 128, the last one padded by 24 rows.
RECURRENT_RUNS = {
    "recurrentgemma-2b": (4096, 2100, (2046, 2100, 100, 37)),
    "mamba2-130m": (2048, 1000, (1000, 100, 37, 128)),
}
# (prompt tokens, temperature) after the long prompt: 6 greedy, 2 at T=0.8
RECURRENT_PROMPTS = [(48, 0.0), (96, 0.0), (32, 0.0), (128, 0.0), (64, 0.0), (80, 0.8), (112, 0.8)]
# K1 sites a layer: RG-LRU in_x / in_gate / gate_a / gate_i / out + the FFN's
# 3; attention q / k / v / o + the FFN's 3; SSD in_proj / out_proj
RECURRENT_K1_SITES = {"r": 8, "l": 7, "s": 2}


def recurrent_k1_per_forward(cfg) -> int:
    return sum(RECURRENT_K1_SITES[kind] for kind in cfg.layer_kinds)


def serve_recurrent(Z, model_cfg, device, Request, ServeEngine, serve_sequential, make_decode_step,
                    ops, ref, kernels, smi: str) -> dict:
    """Serve one recurrent family at full width (its depth as given) through the engine
    on the ``pallas`` backend (K1 at every binary site); hold K1 to its plain
    version in the model, the engine to ``serve_sequential`` and the replayed
    tick to the eager one.  Returns K1's numbers on this path."""
    cfg = with_backend(model_cfg, "pallas")
    k1 = kernels[0]
    max_len, long_len, tick_prompts = RECURRENT_RUNS[cfg.name]
    per_forward = recurrent_k1_per_forward(cfg)
    t = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)
    torch.cuda.synchronize()
    kinds = "".join(cfg.layer_kinds)
    if cfg.ssm is not None:
        s = cfg.ssm
        mixer = (f"{kinds.count('s')} SSD layers: d_inner {s.d_inner(cfg.d_model)}, "
                 f"{s.n_heads(cfg.d_model)} heads of {s.head_dim}, d_state {s.d_state}, conv {s.d_conv}, "
                 f"chunk {s.chunk}")
    else:
        mixer = (f"{kinds.count('r')} RG-LRU layers {cfg.d_model} wide and {kinds.count('l')} local "
                 f"attention layers ({cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.d_head}, window "
                 f"{cfg.window_size}, rope {cfg.rope_theta:g}), each with a {cfg.ffn_type} FFN of {cfg.d_ff}")
    log(f"[9] {cfg.name}: {cfg.n_layers} layers ({cfg.prefix_layers} + {cfg.pattern_period} x "
        f"{cfg.n_periods}): {mixer}; d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"tied={cfg.tie_embeddings}; serving params built on the card in {time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; K1 launches a forward: {per_forward} | {smi}")

    # K1 against its plain version in a short prefill and a decode step;
    # also the family's warm-up
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(40,))
    kern, fed = greedy_steps(Z, cfg, params, prompt, 1, device)
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, _ = greedy_steps(Z, cfg, params, prompt, 1, device, tokens=fed)
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError(f"{cfg.name} logits differ with K1 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in kern):
        raise AssertionError(f"{cfg.name} logits not finite or of the wrong shape")
    log(f"[9] prefill ({len(prompt)} tokens) + decode: logits bitwise equal with binary_qmm swapped for "
        f"binary_qmm_ref on the same tensors")

    def requests():
        rng = np.random.default_rng(0)
        return [Request(prompt=rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int64),
                        max_new_tokens=16, temperature=temp)
                for n, temp in [(long_len, 0.0)] + RECURRENT_PROMPTS]

    engine = ServeEngine(cfg, params, batch_slots=4, max_len=max_len, seed=0, device=device)
    torch.cuda.synchronize()
    _zero(kernels)
    t = time.perf_counter()
    done = engine.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = _counts(kernels)
    if not all(r.state == "ok" and len(r.output) == 16 for r in done):
        raise AssertionError(f"{cfg.name} requests not ok: {[(r.state, len(r.output)) for r in done]}")
    prefill_ms = [e["ms"] for e in engine.last_events if e["kind"] == "prefill"]
    n_tok = sum(len(r.output) for r in done)
    plens = [len(r.prompt) for r in done]
    log(f"[9] served {len(done)} requests (prompts {sorted(plens)} tokens, 16 new each, 6 greedy + 2 at "
        f"T=0.8, 4 slots, max_len {max_len}) in {wall:.2f} s: {n_tok / wall:.1f} generated tokens/s end "
        f"to end; eager exact-length prefills {sum(prefill_ms) / 1e3:.2f} s of it")
    engine_counts(engine, kernels, launched, per_forward, k1, phase=9)
    path = dict(launches=launched[0], replays=engine.decode_fn.replays)
    log("[9] prefill ms per prompt: " + ", ".join(f"{p}:{ms:.1f}" for p, ms in zip(plens, prefill_ms)))
    long_ms = prefill_ms[plens.index(long_len)]
    log(f"[9] the {long_len}-token prefill: {long_ms:.1f} ms in the engine, {long_len / long_ms * 1e3:.0f} "
        "prompt tokens/s")
    del engine
    torch.cuda.empty_cache()
    tokens = torch.as_tensor(np.asarray(done[plens.index(long_len)].prompt)[None], device=device)
    report_profile(f"{cfg.name} eager prefill ({long_len} tokens)", *profile_forward(
        lambda: Z.prefill(params, tokens, cfg, Z.init_slot_cache(max_len, cfg, device=device))), phase=9)

    seq = serve_sequential(cfg, params, requests(), max_len=max_len, seed=0, device=device)
    for got, want in zip(done, seq):
        if got.temperature == 0 and got.output != want.output:
            raise AssertionError(f"{cfg.name} engine greedy tokens ({len(got.prompt)}-token prompt) "
                                 f"{got.output} != sequential {want.output}")
    sampled_same = sum(g.output == w.output for g, w in zip(done, seq) if g.temperature > 0)
    log(f"[9] engine greedy tokens equal serve_sequential for all 6 greedy requests, the {long_len}-token "
        f"prompt among them (sampled requests equal: {sampled_same}/2)")
    del seq, done

    rng = np.random.default_rng(9)
    cache = fill_cache(Z, cfg, params, [rng.integers(0, cfg.vocab_size, size=(n,)) for n in tick_prompts],
                       device, max_len=max_len)
    step = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(len(tick_prompts),))).to(device)
    path.update(graph_vs_eager(
        Z, make_decode_step, cfg, params, cache, max_len, step, k1, per_forward, phase=9,
        tag=f"{cfg.name} pallas decode tick (4 slots at positions {', '.join(map(str, tick_prompts))})"))
    del cache, params
    torch.cuda.empty_cache()
    return path


# ---------------------------------------------------------------------------
# phase 10: the encoder families -- internvl2-2b (patch stub) and
# whisper-tiny (audio encoder + cross-attention)
# ---------------------------------------------------------------------------

INTERNVL_MAX_LEN = 1024
INTERNVL_TEXT = 64  # text tokens after an image's patch positions
WHISPER_MAX_LEN = 448  # the decoder's learned positions
WHISPER_BATCH = 4
WHISPER_PROMPT = 4  # Whisper's start-of-transcript sequence: <sot> <lang> <task> <notimestamps>
WHISPER_STEPS = 32
# K1 sites a layer: attention q / k / v / o; cross-attention q / k / v / o;
# whisper's plain gelu FFN up / down
WHISPER_DECODER_SITES, WHISPER_ENCODER_SITES = 4 + 4 + 2, 4 + 2


def _frontends(cfg, batch: int, n: int, seed: int, device) -> list:
    """``n`` stub frontends (batch, n_positions, d_input or d_model), float32
    normal, from ``seed``."""
    enc = cfg.encoder
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (batch, enc.n_positions, enc.d_input or cfg.d_model)
    return [torch.randn(shape, generator=gen, device=device) for _ in range(n)]


def serve_internvl(Z, model_cfg, device, Request, ServeEngine, serve_sequential, make_decode_step,
                   make_prefill, ops, ref, kernels, smi: str) -> dict:
    """internvl2-2b at full width and depth on the ``pallas`` backend (K1 at
    every binary site): an image prompt through ``make_prefill`` and greedy
    decode steps, held to the eager prefill and to K1's plain version; then
    the engine, text only, held to ``serve_sequential`` and its replayed
    tick to the eager one.  Returns K1's numbers on this path."""
    cfg = with_backend(model_cfg, "pallas")
    k1, enc = kernels[0], cfg.encoder
    per_forward = SITES_PER_LAYER * cfg.n_layers
    t = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)
    torch.cuda.synchronize()
    log(f"[10] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv of {cfg.d_head}, d_ff {cfg.d_ff} ({cfg.ffn_type}), rope {cfg.rope_theta:g}, "
        f"vocab {cfg.vocab_size}, tied={cfg.tie_embeddings}; {enc.kind} of {enc.n_positions} x "
        f"{enc.d_input} (a float32 stub projection, run in bf16); serving params built on the card in "
        f"{time.perf_counter() - t:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; K1 "
        f"launches a forward: {per_forward} | {smi}")

    # the image prompt: patches over the first positions, then text
    plen = enc.n_positions + INTERNVL_TEXT
    frontends = _frontends(cfg, 1, 3, 10, device)
    prompt = np.random.default_rng(10).integers(0, cfg.vocab_size, size=(plen,))
    kern, fed = greedy_steps(Z, cfg, params, prompt, 8, device, frontend=frontends[0])
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, _ = greedy_steps(Z, cfg, params, prompt, 8, device, tokens=fed, frontend=frontends[0])
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError("internvl2 logits differ with K1 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in kern):
        raise AssertionError("internvl2 logits not finite or of the wrong shape")
    text, _ = greedy_steps(Z, cfg, params, prompt, 0, device)
    if torch.equal(text[0], kern[0]):
        raise AssertionError("internvl2: the patches did not change the prefill's logits")
    log(f"[10] image prompt ({enc.n_positions} patch positions + {INTERNVL_TEXT} tokens) + 8 greedy decode "
        f"steps {fed}: logits bitwise equal with binary_qmm swapped for binary_qmm_ref on the same "
        f"tensors; the patches change the prefill's logits (max |diff| against the text-only prefill "
        f"{float((text[0] - kern[0]).abs().max()):.3g})")
    path = dict(prefill_replay_launches=compiled_prefill(
        Z, make_prefill, cfg, params, k1, per_forward, device, prompt_len=plen, max_len=INTERNVL_MAX_LEN,
        frontends=frontends, phase=10, tag=f"internvl2 image prefill ({plen} tokens)"))

    # the engine, text only (as the reference's serves this arch)
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=INTERNVL_MAX_LEN, seed=0, device=device)
    torch.cuda.synchronize()
    reqs = make_requests(Request, vocab=cfg.vocab_size)
    _zero(kernels)
    t = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = _counts(kernels)
    if not all(r.state == "ok" and len(r.output) == 16 for r in done):
        raise AssertionError(f"internvl2 requests not ok: {[(r.state, len(r.output)) for r in done]}")
    prefill_ms = [e["ms"] for e in engine.last_events if e["kind"] == "prefill"]
    n_tok = sum(len(r.output) for r in done)
    plens = [len(r.prompt) for r in done]
    log(f"[10] internvl2 engine (text only): served {len(done)} requests (prompts {sorted(plens)} tokens, "
        f"16 new each, 6 greedy + 2 at T=0.8, 4 slots, max_len {INTERNVL_MAX_LEN}) in {wall:.2f} s: "
        f"{n_tok / wall:.1f} generated tokens/s end to end; eager exact-length prefills "
        f"{sum(prefill_ms) / 1e3:.2f} s of it")
    engine_counts(engine, kernels, launched, per_forward, k1, phase=10)
    path.update(launches=launched[0], replays=engine.decode_fn.replays)
    log("[10] prefill ms per prompt: " + ", ".join(f"{p}:{ms:.1f}" for p, ms in zip(plens, prefill_ms)))
    del engine
    torch.cuda.empty_cache()
    long = max(done, key=lambda r: len(r.prompt))
    tokens = torch.as_tensor(np.asarray(long.prompt)[None], device=device)
    report_profile(f"internvl2 eager prefill ({len(long.prompt)} tokens)", *profile_forward(
        lambda: Z.prefill(params, tokens, cfg, Z.init_slot_cache(INTERNVL_MAX_LEN, cfg, device=device))),
        phase=10)

    seq = serve_sequential(cfg, params, make_requests(Request, vocab=cfg.vocab_size),
                           max_len=INTERNVL_MAX_LEN, seed=0, device=device)
    for got, want in zip(done, seq):
        if got.temperature == 0 and got.output != want.output:
            raise AssertionError(f"internvl2 engine greedy tokens {got.output} != sequential {want.output}")
    sampled_same = sum(g.output == w.output for g, w in zip(done, seq) if g.temperature > 0)
    log(f"[10] internvl2 engine greedy tokens equal serve_sequential for all 6 greedy requests "
        f"(sampled requests equal: {sampled_same}/2)")
    cache = fill_cache(Z, cfg, params, [r.prompt for r in done[:4]], device, max_len=INTERNVL_MAX_LEN)
    step = torch.tensor([r.output[0] for r in done[:4]], device=device)
    path.update(graph_vs_eager(Z, make_decode_step, cfg, params, cache, INTERNVL_MAX_LEN, step, k1,
                               per_forward, phase=10, tag="internvl2 pallas decode tick (4 slots)"))
    del cache, params, seq, done
    torch.cuda.empty_cache()
    return path


def serve_whisper(Z, model_cfg, device, ServeEngine, make_decode_step, make_prefill, ops, ref,
                  kernels, smi: str) -> dict:
    """whisper-tiny at full width and depth on the ``pallas`` backend (K1 at
    every binary site): a batch-4 transcription through ``make_prefill``
    (stub frames through the encoder) and a replayed ``make_decode_step``
    (cross-attention onto the cached encoder output); the compiled steps
    held to the eager ones and K1 to its plain version.  Returns K1's
    numbers on this path."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L

    cfg = with_backend(model_cfg, "pallas")
    k1, enc = kernels[0], cfg.encoder
    b, max_len = WHISPER_BATCH, WHISPER_MAX_LEN
    per_decode = WHISPER_DECODER_SITES * cfg.n_layers
    per_prefill = per_decode + WHISPER_ENCODER_SITES * enc.n_layers
    t = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)
    torch.cuda.synchronize()
    log(f"[10] {cfg.name}: {enc.n_layers} encoder layers over {enc.n_positions} stub frames (sinusoidal "
        f"positions, non-causal, stateless) + {cfg.n_layers} decoder layers (learned positions up to "
        f"{cfg.max_seq}, cross-attention onto the encoder's output); d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads of {cfg.d_head}, d_ff {cfg.d_ff} ({cfg.ffn_type}), vocab {cfg.vocab_size}, "
        f"tied={cfg.tie_embeddings}; serving params built on the card in {time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; K1 launches: {per_prefill} a prefill, "
        f"{per_decode} a decode step | {smi}")
    try:
        ServeEngine(cfg, params, batch_slots=b, max_len=max_len, device=device)
    except NotImplementedError as e:
        log(f"[10] ServeEngine refuses {cfg.name}, as the reference's does: {e}")
    else:
        raise AssertionError("ServeEngine accepted a model with an encoder stack")

    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, WHISPER_PROMPT))).to(device)
    frontends = _frontends(cfg, b, 4, 11, device)

    def eager_steps(frontend, n_decode: int, tokens=None):
        """An eager prefill and ``n_decode`` decode steps, greedy or fed
        ``tokens``; returns (logits per step, tokens fed, cache)."""
        cache = Z.init_cache(b, max_len, cfg, device=device)
        logits, _ = Z.prefill(params, prompt, cfg, cache, frontend)
        out, fed = [logits], []
        for i in range(n_decode):
            tok = out[-1].argmax(-1) if tokens is None else tokens[i]
            fed.append(tok)
            logits, _ = Z.decode_step(params, tok, cfg, cache)
            out.append(logits)
        return out, fed, cache

    # K1 against its plain version in a prefill and a decode step; K1's
    # calls counted by their M (also the phase's warm-up)
    rows_m = []
    real = ops.binary_qmm_int

    def recording(a, *args):
        rows_m.append(a.shape[0])
        return real(a, *args)

    with mock.patch.object(ops, "binary_qmm_int", recording):
        kern, fed, _ = eager_steps(frontends[0], 1)
    n_pre = len(rows_m) - per_decode
    m_cross = sum(m == b * enc.n_positions for m in rows_m[n_pre:])
    if n_pre != per_prefill or m_cross != 2 * cfg.n_layers:
        raise AssertionError(f"whisper K1 calls {n_pre} a prefill, {len(rows_m) - n_pre} a decode step, "
                             f"{m_cross} at M = {b * enc.n_positions}")
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, _, _ = eager_steps(frontends[0], 1, tokens=fed)
    if not all(torch.equal(a, b_) for a, b_ in zip(kern, plain)):
        raise AssertionError("whisper logits differ with K1 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (b, cfg.vocab_size) for x in kern):
        raise AssertionError("whisper logits not finite or of the wrong shape")
    log(f"[10] whisper prefill ({b} x {WHISPER_PROMPT} tokens, {b} x {enc.n_positions} frames) + decode "
        f"step: binary_qmm calls {n_pre} + {len(rows_m) - n_pre}, {m_cross} of the decode step's at "
        f"M = {b * enc.n_positions} (cross-attention k / v); logits bitwise equal with binary_qmm "
        f"swapped for binary_qmm_ref on the same tensors")

    # the transcription: a captured prefill, then greedy replayed decode steps
    pre = make_prefill(cfg, b, WHISPER_PROMPT, max_len, device=device)
    dec = make_decode_step(cfg, b, max_len, device=device)
    cache = Z.init_cache(b, max_len, cfg, device=device)
    torch.cuda.synchronize()
    _zero(kernels)
    t = time.perf_counter()
    logits, _ = pre(params, prompt, cache, frontends[1])
    tokens = [logits.argmax(-1)]
    for _ in range(WHISPER_STEPS):
        logits, _ = dec(params, tokens[-1], cache)
        tokens.append(logits.argmax(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = _counts(kernels)
    want = [2 * (per_prefill + per_decode), 0, 0, 0]
    if launched != want or (pre.captures, dec.captures, dec.replays) != (1, 1, WHISPER_STEPS - 1):
        raise AssertionError(f"whisper transcription launches {launched}, expected {want}; "
                             f"{pre.captures} / {dec.captures} captures, {dec.replays} replays")
    if not bool(torch.isfinite(logits).all()) or logits.shape != (b, cfg.vocab_size):
        raise AssertionError("whisper transcription logits not finite or of the wrong shape")
    path = dict(launches=launched[0], replays=dec.replays)
    log(f"[10] whisper transcription: make_prefill (capture) + {WHISPER_STEPS} greedy make_decode_step "
        f"calls (1 capture + {dec.replays} replays) in {wall * 1e3:.1f} ms, {b * (WHISPER_STEPS + 1)} tokens; "
        f"binary_qmm wrapper launches {launched[0]} = 2 x ({per_prefill} + {per_decode}) for the two "
        f"captures (warm-up run + capture), replays call none; row 0's tokens "
        f"{[int(x[0]) for x in tokens[:12]]}...")
    del pre, dec, cache
    torch.cuda.empty_cache()

    path["prefill_replay_launches"] = compiled_prefill(
        Z, make_prefill, cfg, params, k1, per_prefill, device, prompt_len=WHISPER_PROMPT, batch=b,
        max_len=max_len, frontends=frontends[1:], phase=10,
        tag=f"whisper prefill ({b} x {WHISPER_PROMPT} tokens + {enc.n_positions} frames)")
    first, _, cache = eager_steps(frontends[2], 0)
    path.update(graph_vs_eager(Z, make_decode_step, cfg, params, cache, max_len, first[0].argmax(-1), k1, per_decode,
                               phase=10, tag=f"whisper pallas decode step ({b} rows)", n_ticks=WHISPER_STEPS))

    # the cross-attention's share of the replayed tick: its k / v
    # projections over every encoder row, and its float core, each alone
    enc_out = cache["encoder_out"]
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    q = torch.randn((b, 1, cfg.n_heads, cfg.d_head), generator=gen, device=device).to(torch.bfloat16)
    layers = [p["cross_attn"] for p in params["layers"]]
    kv = [tuple(L.qlinear(p[s], enc_out, cfg.quant).reshape(b, enc.n_positions, cfg.n_kv_heads, cfg.d_head)
                for s in ("k", "v")) for p in layers]
    sqrt_dh = torch.sqrt(torch.tensor(float(cfg.d_head), device=device))
    mask = A._mask(1, enc.n_positions, False, 0, device)

    def projections():
        for p in layers:
            L.qlinear(p["k"], enc_out, cfg.quant)
            L.qlinear(p["v"], enc_out, cfg.quant)

    def float_core():
        for ck, cv in kv:
            A._pv_float(L.softmax(A._scores_float(q, ck) / sqrt_dh + mask), cv, torch.bfloat16)

    kv_ms, core_ms = device_ms([projections], 10), device_ms([float_core], 10)
    busy = path["replay_busy_ms"]
    log(f"[10] whisper decode step, each alone in a replayed graph: the cross-attention k / v projections "
        f"({2 * cfg.n_layers} binary_qmm at M = {b * enc.n_positions}, with their per-token quantization and "
        f"epilogue) {kv_ms:.3f} ms ({kv_ms / busy:.1%} of the replayed step's {busy:.3f} ms busy); the "
        f"float cross-attention (float32 scores over {enc.n_positions} rows, softmax, bf16 P.V; "
        f"{cfg.n_layers} layers) {core_ms:.3f} ms ({core_ms / busy:.1%})")
    path.update(cross_kv_ms=kv_ms, cross_float_ms=core_ms)
    del cache, params, kv
    torch.cuda.empty_cache()
    return path


# ---------------------------------------------------------------------------
# phase 12: bitwise attention -- the AND-popcount scores kernel, bit-bert-base
# with attn.qk -> binary, and measured dispatch
# ---------------------------------------------------------------------------

# (tag, (B, H, S), (B, G, T), dh): bit-bert-base's 128-token prefill and
# its 4-slot decode over max_len 512, a GQA decode (32 query heads over 8
# kv heads of 128), MLA's latent decode (16 heads over the kv_lora 512
# latent, 2,048 rows), and ragged dh and T.  The first is the headline row.
BINARY_ATTN_CASES = [
    ("bit-bert prefill", (1, 12, 128), (1, 12, 128), 64),
    ("bit-bert decode", (4, 12, 1), (4, 12, 512), 64),
    ("GQA decode", (4, 32, 1), (4, 8, 512), 128),
    ("MLA latent decode", (4, 16, 1), (4, 1, 2048), 512),
    ("ragged", (2, 6, 5), (2, 3, 333), 100),
]
BINARY_ATTN_LAYERS = 12  # bit-bert-base: one scores launch a layer
AUTOTUNE_REQUESTS = 4


def check_binary_attn(gen: torch.Generator) -> list:
    """The scores kernel against its plain version, bit for bit, on the
    layouts the model hands it: Q a transposed view of ``(B, S, H, dw)``
    words, K the packed cache ``(B, T, G, dw)`` permuted to ``(B, G, T,
    dw)`` (strided, read in place).  Timed as phase 2 times K3, beside its
    bound, its plain version and ``torch.bmm`` in float32 on the planes
    unpacked beforehand."""
    from repro_torch.core import packing
    from repro_torch.kernels import ref
    from repro_torch.kernels.binary_attn import binary_attn_scores_planes as kernel
    from repro_torch.kernels.binary_attn import plan

    dev = gen.device
    rows = []
    for tag, (b, h, s), (_, g, t), dh in BINARY_ATTN_CASES:
        dw = packing.packed_len(dh, 1)

        def planes(shape):
            bits = torch.randint(0, 2, shape + (dh,), generator=gen, device=dev, dtype=torch.int8)
            return packing.pack_bits(bits, 1, axis=-1)

        q = planes((b, s, h)).transpose(1, 2)
        ks = [planes((b, t, g)).permute(0, 2, 1, 3) for _ in range(_copies(4 * b * g * t * dw))]
        got, want = kernel(q, ks[0], dh=dh), ref.binary_attn_scores_ref(q, ks[0], dh)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"binary_attn_scores_planes != plain at {tag}: max |diff| "
                                 f"{(got - want).abs().max().item()}")
        qf = packing.unpack_bits(q, 1, dh, dtype=torch.float32).reshape(b * g, (h // g) * s, dh)
        kf = packing.unpack_bits(ks[0], 1, dh, dtype=torch.float32).reshape(b * g, t, dh).transpose(1, 2)
        if not torch.equal(torch.bmm(qf, kf).reshape(b, h, s, t).to(torch.int32), want):
            raise AssertionError(f"torch.bmm disagrees with binary_attn_scores_ref at {tag}")
        n_out = b * h * s * t
        nb, bb = bound(4 * (b * h * s * dw + b * g * t * dw) + 4 * n_out, 2 * n_out * dh, PEAK_B1_OPS_PER_S)
        calls = [lambda k=k: kernel(q, k, dh=dh) for k in ks]
        rows.append(dict(
            case=tag, shape=[[b, h, s, dw], [b, g, t, dw]], dh=dh, plan=plan(b, h, g, s, t),
            max_abs_err=int((got - want).abs().max()),
            ms=device_ms(calls, 20 * len(calls)), eager_ms=time_ms(calls, 20 * len(calls)),
            plain_ms=time_ms([lambda: ref.binary_attn_scores_ref(q, ks[0], dh)], 3),
            bound_ms=nb, bound_by=bb,
            library="torch.bmm (float32, planes unpacked beforehand)",
            library_ms=device_ms([lambda: torch.bmm(qf, kf)], 20),
        ))
        r = rows[-1]
        log(f"  binary_attn   {tag:18s} q {tuple(q.shape)} k {tuple(ks[0].shape)} dh {dh}: plan "
            f"{r['plan']['rows']} rows x {r['plan']['keys']} keys a block, grid {r['plan']['grid']}; "
            f"equal ms={r['ms']:.4f} eager_ms={r['eager_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({bb}) plain_ms={r['plain_ms']:.3f} library_ms={r['library_ms']:.4f} [{r['library']}]")
        del ks
    torch.cuda.empty_cache()
    return rows


def _with_qk(cfg, backend: str):
    return dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, backend_overrides=(("attn.qk", backend),)))


def _k_bytes(cache) -> int:
    return sum(layer["k"].numel() * layer["k"].element_size() for layer in cache["layers"])


def serve_binary_attention(Z, bert_cfg, device, Request, ServeEngine, serve_sequential,
                           make_decode_step, make_prefill, ops, ref, kernels) -> dict:
    """[12b] bit-bert-base W1A1 with ``attn.qk -> binary`` at full width,
    autotuning off (the scores core is then the kernel): the engine run,
    its tokens against ``serve_sequential`` and the ``float`` core, the
    replayed tick and 128-token prefill against the eager ones, the K
    cache's bytes.  [12c] autotuning on over a cache file, then a second
    engine that loads it.  Returns the kernel's main-path numbers."""
    import os
    import tempfile

    from repro_torch.core import backend_registry, dispatch

    attn = kernels[4]
    cfg = _with_qk(with_backend(bert_cfg, "pallas"), "binary")
    k3_per_forward = BERT_SITES_PER_LAYER * cfg.n_layers
    per_forward = BINARY_ATTN_LAYERS
    if cfg.n_layers != per_forward and device.type == "cuda":
        raise AssertionError(f"{cfg.name} has {cfg.n_layers} layers, expected {per_forward}")
    params = Z.init_serving_params(0, cfg, device=device)

    def requests(n=8, seed=0):
        return make_requests(Request, n=n, seed=seed, vocab=cfg.vocab_size, lo=64, hi=128)

    with mock.patch.dict(os.environ, {"REPRO_QMM_AUTOTUNE": "0"}):
        ServeEngine(cfg, params, batch_slots=4, max_len=512, seed=0, device=device).run(requests(n=2, seed=1))
        engine = ServeEngine(cfg, params, batch_slots=4, max_len=512, seed=0, device=device)
        torch.cuda.synchronize()
        _zero(kernels)
        t = time.perf_counter()
        done = engine.run(requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = _counts(kernels)
        if not all(r.state == "ok" and len(r.output) == 16 for r in done):
            raise AssertionError(f"binary-attention requests not ok: {[(r.state, len(r.output)) for r in done]}")
        prefill_ms = [e["ms"] for e in engine.last_events if e["kind"] == "prefill"]
        n_tok = sum(len(r.output) for r in done)
        log(f"[12] {cfg.name} W1A1, attn.qk -> binary (autotuning off: the scores core is the kernel): "
            f"served {len(done)} requests, 16 new tokens each, in {wall:.2f} s: {n_tok / wall:.1f} "
            f"generated tokens/s end to end; eager prefills {sum(prefill_ms) / 1e3:.2f} s of it")
        engine_counts(engine, kernels, launched, k3_per_forward, kernels[2], phase=12,
                      also=((attn, per_forward),))
        path = dict(launches=launched[4], replays=engine.decode_fn.replays)
        binary_k, int8_k = _k_bytes(engine._cache), _k_bytes(Z.init_cache(4, 512, bert_cfg, device=device))
        dh = cfg.d_head
        if binary_k * dh != int8_k * 4 * -(-dh // 32):  # 8x at d_head 64: 2 words for 64 bytes
            raise AssertionError(f"packed K cache {binary_k} bytes, int8 {int8_k}: not {dh} bytes "
                                 f"for {-(-dh // 32)} words a row")
        log(f"[12] K cache of the 4-slot engine at max_len 512, {cfg.n_layers} layers: packed {binary_k / 1e6:.3f} "
            f"MB beside phase 5's int8 {int8_k / 1e6:.3f} MB ({int8_k / binary_k:.0f}x smaller); V int8 as there")
        del engine

        seq = serve_sequential(cfg, params, requests(), max_len=512, seed=0, device=device)
        fl = serve_sequential(_with_qk(cfg, "float"), params, requests(), max_len=512, seed=0, device=device)
        for got, want, flt in zip(done, seq, fl):
            if got.temperature == 0 and not (got.output == want.output == flt.output):
                raise AssertionError(f"binary-attention greedy tokens: engine {got.output}, sequential "
                                     f"{want.output}, float core {flt.output}")
        log("[12] engine greedy tokens equal serve_sequential's and the float core's (attn.qk -> float) "
            "for all 6 greedy requests")

        cache = fill_cache(Z, cfg, params, [r.prompt for r in done[:4]], device)
        step = torch.tensor([r.output[0] for r in done[:4]], device=device)
        path.update(graph_vs_eager(Z, make_decode_step, cfg, params, cache, 512, step, attn,
                                   per_forward, phase=12, tag="W1A1 binary-attention decode tick (4 slots)"))
        del cache
        path["prefill_replay_launches"] = compiled_prefill(
            Z, make_prefill, cfg, params, attn, per_forward, device, phase=12,
            tag="128-token binary-attention prefill")

        prompt = np.asarray(max(done, key=lambda r: len(r.prompt)).prompt)
        kern, fed = greedy_steps(Z, cfg, params, prompt, 1, device)
        spec = backend_registry.get_backend("binary")
        plain = dataclasses.replace(spec, run_scores=lambda q, k, *, dh: ref.binary_attn_scores_ref(q, k, dh))
        with mock.patch.dict(backend_registry._REGISTRY, {"binary": plain}):
            plain_out, _ = greedy_steps(Z, cfg, params, prompt, 1, device, tokens=fed)
        if not all(torch.equal(a, b) for a, b in zip(kern, plain_out)):
            raise AssertionError("binary-attention logits differ with the scores kernel swapped for its plain version")
        if not all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in kern):
            raise AssertionError("binary-attention logits not finite or of the wrong shape")
        log(f"[12] prefill ({len(prompt)} tokens) + decode logits bitwise equal with "
            "binary_attn_scores_planes swapped for binary_attn_scores_ref on the same tensors")

    # [12c] autotuning on: every linear site "auto", the scores core "auto"
    acfg = _with_qk(with_backend(bert_cfg, "auto"), "binary")
    reqs = lambda: requests(n=AUTOTUNE_REQUESTS, seed=2)  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(os.environ, {"REPRO_QMM_AUTOTUNE": "1"}):
        file = os.path.join(tmp, "autotune.json")
        first = dispatch.reset_cache()
        t = time.perf_counter()
        a = ServeEngine(acfg, params, batch_slots=4, max_len=512, seed=0, device=device,
                        autotune_cache_path=file).run(reqs())
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t
        if any(b not in ("pallas", "fused", "binary") for key in first.entries for b in key.candidates):
            raise AssertionError(f"a plain core is an autotune candidate on the card: {list(first.entries)}")
        again = dispatch.AutotuneCache()
        agree = 0
        for key, rec in sorted(first.entries.items(), key=lambda kv: (kv[0].family, kv[0].tag, kv[0].m, kv[0].n)):
            redo = again.choose(key.m, key.k, key.n, key.act_bits, key.weight_bits, tag=key.tag,
                                family=key.family, device=device)
            agree += redo == rec.backend
            times = ", ".join(f"{b} {us:.2f}" for b, us in rec.timings_us.items()) or "one candidate, untimed"
            redo_times = ", ".join(f"{b} {us:.2f}" for b, us in again.entries[key].timings_us.items())
            log(f"[12] autotune {key.family} {key.tag} m={key.m} k={key.k} n={key.n} "
                f"A{key.act_bits}W{key.weight_bits} {key.candidates}: us {times} -> {rec.backend}"
                + (f"; timed again: us {redo_times} -> {redo}" if redo_times else ""))
        log(f"[12] autotune winners timed again in a fresh cache: {agree} of {len(first)} keys agree")
        second = dispatch.reset_cache()
        t = time.perf_counter()
        b_ = ServeEngine(acfg, params, batch_slots=4, max_len=512, seed=0, device=device,
                         autotune_cache_path=file).run(reqs())
        torch.cuda.synchronize()
        t_second = time.perf_counter() - t
        if [r.output for r in a] != [r.output for r in b_] or second.timing_runs != 0:
            raise AssertionError(f"the engine loading the autotune file: {second.timing_runs} timing runs, "
                                 "tokens equal: " + str([r.output for r in a] == [r.output for r in b_]))
        if not all(r.state == "ok" for r in a + b_):
            raise AssertionError("autotuned requests not ok")
        winners = {}
        for rec in first.entries.values():
            winners[rec.backend] = winners.get(rec.backend, 0) + 1
        log(f"[12] autotuning on: {len(first)} keys, {first.timing_runs} timing runs, winners {winners}; "
            f"{AUTOTUNE_REQUESTS} requests in {t_first:.2f} s; a second engine loading the file: "
            f"{len(second)} keys, 0 timing runs, the same tokens, {t_second:.2f} s")
        path["autotune"] = dict(keys=len(first), timing_runs=first.timing_runs, winners=winners,
                                winners_agree_when_timed_again=agree)
        dispatch.reset_cache()
    del params
    torch.cuda.empty_cache()
    return path


# ---------------------------------------------------------------------------
# phase 13: fault-tolerant serving on granite-8b, snapshots, resume after a
# SIGKILL, and float serving
# ---------------------------------------------------------------------------

ROBUST_PLAN = {"decode_fail_ticks": [2, 5], "nan_ticks": {"3": 1}, "prefill_fail_rids": {"5": 1},
               "snapshot_fail_at": [0]}
# what ROBUST_PLAN implies: two transient tick faults, each retried once;
# one NaN row and one failed prefill, each re-admitted once; one failed
# snapshot write
ROBUST_EVENTS = {"step_fault": 2, "retry_tick": 2, "nan_logits": 1, "requeue": 2, "prefill_fault": 1,
                 "snapshot_failed": 1, "request_failed": 0, "demote": 0}
CRASH_AFTER_TICKS = 13  # (d): the run cut at this tick, resumed from its last snapshot
KILL_ARGS = ["--requests", "8", "--max-new", "24", "--snapshot-every", "4",
             "--fault-plan", '{"every_tick_delay_s": 0.2}']
KILL_TIMEOUT_S = 240
PAD_TO = 128  # (f): the bucket a right-padded prefill batch is padded to


class _Crash(Exception):
    """Raised from a streaming callback to cut a run mid-batch."""


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _kinds(events) -> Counter:
    return Counter(e["kind"] for e in events)


def _committed(snap: Path) -> list:
    return sorted(p.name for p in snap.glob("step_*") if (p / "_COMMITTED").exists())


def serve_robust(Z, model_cfg, device, Request, ServeEngine, serve_sequential, make_decode_step, kernels,
                 smi, workdir: Path, child_args=("--arch", "granite-8b")):
    """Phase 13 (a)-(e) on ``model_cfg`` at W1A8 (K1, ``pallas``), 4 slots,
    max_len 512, phase 3's 8 requests.  Returns the main-path numbers of K1
    (the faulted run) and K2 (the demotion run)."""
    from repro_torch.core import dispatch
    from repro_torch.launch import serve as cli
    from repro_torch.runtime.faults import parse_fault_plan

    cfg = with_backend(model_cfg, "pallas")
    per_forward = SITES_PER_LAYER * cfg.n_layers
    k1, k2 = kernels[0], kernels[1]
    t_phase = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)

    def requests(**kw):
        return make_requests(Request, vocab=cfg.vocab_size, **kw)

    def engine(c=cfg, **kw):
        return ServeEngine(c, params, batch_slots=4, max_len=512, seed=0, device=device, **kw)

    base = [r.output for r in engine().run(requests())]

    # (a) transient faults on pallas, snapshots every 4 ticks
    snap_a = workdir / "a"
    eng = engine(fault_plan=ROBUST_PLAN, snapshot_every=4, snapshot_dir=str(snap_a))
    _zero(kernels)
    done = eng.run(requests())
    launched = _counts(kernels)
    kinds = _kinds(eng.last_events)
    got_kinds = {k: kinds.get(k, 0) for k in ROBUST_EVENTS}
    if got_kinds != ROBUST_EVENTS:
        raise AssertionError(f"[13a] events {got_kinds}, the plan implies {ROBUST_EVENTS}")
    if [r.state for r in done] != ["ok"] * len(done) or [r.output for r in done] != base:
        raise AssertionError(f"[13a] states {[r.state for r in done]}; outputs equal to the unfailed "
                             f"run's: {[r.output == b for r, b in zip(done, base)]}")
    if launched[0] == 0 or any(launched[1:]):
        raise AssertionError(f"[13a] wrapper launches {launched}: K1 only expected")
    snaps = [e["ms"] for e in eng.last_events if e["kind"] == "snapshot"]
    step_dir = snap_a / _committed(snap_a)[-1]
    log(f"[13a] {cfg.name} W1A8 pallas under {json.dumps(ROBUST_PLAN)}: {len(done)} requests ok, all "
        f"8 outputs (2 at T=0.8) equal to the unfailed run's token for token; events {got_kinds}; "
        f"retries {[r.retries for r in done]}; binary_qmm launches {launched[0]}, "
        f"{eng.decode_fn.captures} capture, {eng.decode_fn.replays} replays | {smi}")
    log(f"[13a] {len(snaps)} snapshots (every 4 ticks, one write failed on purpose): {_dir_bytes(step_dir) / 1e6:.1f} "
        f"MB each (the 4-slot int8 cache and the scheduler's state), ms median {np.median(snaps):.1f} "
        f"min {np.min(snaps):.1f} max {np.max(snaps):.1f}")
    robust = dict(launches=launched[0], replays=eng.decode_fn.replays, snapshot_ms=float(np.median(snaps)),
                  snapshot_bytes=_dir_bytes(step_dir))
    del eng

    # (b) demotion: fused fails twice, the engine pins fused -> pallas and
    # captures its decode step anew
    fcfg = with_backend(cfg, "fused")
    eng = engine(fcfg, demote_to="pallas", demote_after=2)
    eng.run(requests(n=2, seed=1))  # captures the fused step
    fused_pool = pool_bytes(eng.decode_fn.graph)
    eng.fault_plan = parse_fault_plan({"backend_fail": {"fused": 2}})
    _zero(kernels)
    done = eng.run(requests())
    launched = _counts(kernels)
    kinds = _kinds(eng.last_events)
    if kinds.get("demote") != 1 or kinds.get("backend_fault") != 2 or kinds.get("compile") != 1:
        raise AssertionError(f"[13b] events {kinds}: one demote after two backend faults, one capture")
    if dispatch.demotions() != {"fused": "pallas"} or eng.decode_fn.captures != 1:
        raise AssertionError(f"[13b] demotions {dispatch.demotions()}, {eng.decode_fn.captures} captures")
    if not all(r.state == "ok" and len(r.output) == r.max_new_tokens for r in done):
        raise AssertionError(f"[13b] requests {[(r.state, len(r.output)) for r in done]}")
    # the first 4 admissions prefill on fused; the demotion's capture and
    # every later prefill run on pallas
    want = [(4 + 2) * per_forward, 4 * per_forward, 0, 0]
    if launched != want:
        raise AssertionError(f"[13b] wrapper launches {launched}, expected {want}")
    prof = profile_forward(lambda: eng.decode_fn.graph.replay())
    on_device = ours(prof[4])
    if (on_device["binary_qmm"], on_device["fused_qmm"]) != (per_forward, 0):
        raise AssertionError(f"[13b] the profiled replay after the demotion ran {on_device}")
    pallas_pool = pool_bytes(eng.decode_fn.graph)

    def gb(pool):
        return "not measured" if pool is None else f"{pool[0] / 1e9:.3f} GB reserved, {pool[1] / 1e9:.3f} in use"

    log(f"[13b] fused -> pallas after 2 backend faults: 1 demote, a second capture ({eng.decode_fn.captures} "
        f"on the new step); wrapper launches K1 {launched[0]} = 6 x {per_forward}, K2 {launched[1]} = 4 x "
        f"{per_forward} (4 fused prefills before the demotion); the profiled replay after it: binary_qmm "
        f"{on_device['binary_qmm']}, fused_qmm {on_device['fused_qmm']}, busy {prof[1]:.2f} ms; "
        f"graph pools: fused {gb(fused_pool)}, pallas {gb(pallas_pool)}; all 8 requests ok | {smi}")
    demotion = dict(launches=launched[1], replay_launches=on_device["fused_qmm"])
    dispatch.clear_demotions()
    del eng
    torch.cuda.empty_cache()

    # (c) deadlines: two requests of 0.5 s behind a 1 s stall at tick 3
    reqs = requests()
    for r in reqs[:2]:
        r.deadline_s = 0.5
    eng = engine(fault_plan={"delay_ticks": {"3": 1.0}})
    done = eng.run(reqs)
    misses = [e for e in eng.last_events if e["kind"] == "deadline_miss"]
    if [r.state for r in done] != ["deadline"] * 2 + ["ok"] * 6 or [r.output for r in done[2:]] != base[2:]:
        raise AssertionError(f"[13c] states {[r.state for r in done]}")
    if sorted(e["rid"] for e in misses) != [done[0].rid, done[1].rid] or any(e["slot"] is None for e in misses):
        raise AssertionError(f"[13c] deadline misses {misses}")
    log(f"[13c] deadline_s=0.5 on 2 requests, a 1.0 s stall before tick 3: both end 'deadline' in their "
        f"slots (at {[round(e['t'], 3) for e in misses]} s, after {[len(r.output) for r in done[:2]]} "
        f"tokens), their slots reset and refilled; the other 6 end ok with the unfailed run's tokens")
    del eng

    # (d) resume in process: (a)'s run cut at tick CRASH_AFTER_TICKS, its
    # last snapshot resumed by a new engine, twice
    snap_d = workdir / "d"
    eng = engine(fault_plan=ROBUST_PLAN, snapshot_every=4, snapshot_dir=str(snap_d))
    reqs = requests()

    def cut(_tok):
        if sum(e["kind"] in ("decode_tick", "compile") for e in eng.last_events) >= CRASH_AFTER_TICKS:
            raise _Crash()

    reqs[0].on_token = cut
    try:
        eng.run(reqs)
        raise AssertionError("[13d] the run was not cut")
    except _Crash:
        pass
    del eng
    fresh = engine(snapshot_dir=str(snap_d))
    runs = []
    for _ in range(2):
        res = fresh.resume()
        first = fresh.last_events[0]
        runs.append((first["tick"], first["ms"], [r.output for r in res], _kinds(fresh.last_events)))
    if any(out != base for _, _, out, _ in runs) or fresh.decode_fn.captures != 1 or runs[1][3].get("compile"):
        raise AssertionError(f"[13d] resumed outputs equal: {[out == base for _, _, out, _ in runs]}; "
                             f"captures {fresh.decode_fn.captures}")
    restore_bytes = _dir_bytes(snap_d / _committed(snap_d)[-1])
    log(f"[13d] a new engine resumed the run cut at tick {CRASH_AFTER_TICKS} from its snapshot at tick "
        f"{runs[0][0]}: restore {runs[0][1]:.1f} ms then {runs[1][1]:.1f} ms for {restore_bytes / 1e6:.1f} MB; "
        f"all 8 outputs equal to the uninterrupted run's, both times; 1 capture (the first resume's first "
        f"tick), the second resume replays the same graph ({fresh.decode_fn.replays} replays in all) | {smi}")
    robust.update(restore_ms=runs[1][1], restore_bytes=restore_bytes)
    del fresh

    # (e) SIGKILL: a serving process killed once its second snapshot is
    # committed, resumed here
    snap_e = workdir / "e"
    argv = [*child_args, *KILL_ARGS, "--snapshot-dir", str(snap_e)]
    out_path = workdir / "child.log"
    t = time.perf_counter()
    with open(out_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *argv], cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            seen = set()
            while time.perf_counter() - t < KILL_TIMEOUT_S and proc.poll() is None and len(seen) < 2:
                seen.update(_committed(snap_e))
                time.sleep(0.02)
            alive = proc.poll() is None
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    kill_s = time.perf_counter() - t
    if len(seen) < 2 or not alive or proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"[13e] child: snapshots seen {sorted(seen)}, alive at the kill {alive}, "
                             f"rc {proc.returncode}; its output:\n{out_path.read_text()[-3000:]}")
    # the child's config and geometry; its weights are this phase's (seed 0)
    args = cli.parser().parse_args(argv)
    kcfg = cli.serving_config(args.arch, args.smoke, args.device)

    def kill_engine(**kw):
        return ServeEngine(kcfg, params, batch_slots=args.slots, max_len=args.max_len, seed=args.seed,
                           device=device, **kw)

    want = [r.output for r in kill_engine().run(cli.fixed_queue(args, kcfg.vocab_size))]
    res = kill_engine(snapshot_dir=str(snap_e)).resume()
    if [r.output for r in res] != want or any(r.state != "ok" for r in res):
        raise AssertionError(f"[13e] resumed outputs equal: {[r.output == w for r, w in zip(res, want)]}")
    child = [ln for ln in out_path.read_text().splitlines() if ln.startswith("[serve]")]
    log(f"[13e] `python -m repro_torch.launch.serve {' '.join(argv)}` SIGKILLed {kill_s:.1f} s after its "
        f"start, snapshots {sorted(seen)} committed; resumed here from {_committed(snap_e)[-1]}: all "
        f"{len(res)} outputs equal to an uninterrupted run's; the child said {child}")
    del params
    torch.cuda.empty_cache()
    log(f"[13] (a)-(e) took {time.perf_counter() - t_phase:.1f} s")
    return robust, demotion


def serve_float(Z, model_cfg, device, Request, ServeEngine, serve_sequential, make_decode_step, kernels,
                smi, int8_cache_bytes: int):
    """Phase 13 (f): ``model_cfg`` with ``FLOAT_QUANT`` (bf16 weights and
    caches): the engine against ``serve_sequential``, the bf16 cache's
    bytes, the replayed tick timed and profiled, and a right-padded batch
    through ``prefill(length=)`` against exact-length prefills."""
    from repro_torch.configs.base import FLOAT_QUANT

    cfg = dataclasses.replace(model_cfg, quant=FLOAT_QUANT)
    t = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)
    torch.cuda.synchronize()
    log(f"[13f] {cfg.name} FLOAT_QUANT: bf16 params built on the card in {time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=512, seed=0, device=device)
    t = time.perf_counter()
    done = engine.run(make_requests(Request, vocab=cfg.vocab_size))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    seq = serve_sequential(cfg, params, make_requests(Request, vocab=cfg.vocab_size), max_len=512, seed=0,
                           device=device)
    if not all(r.state == "ok" for r in done) or any(
            g.output != w.output for g, w in zip(done, seq) if g.temperature == 0):
        raise AssertionError("[13f] float engine greedy tokens differ from serve_sequential's")
    ticks = [e["ms"] for e in engine.last_events if e["kind"] == "decode_tick"]
    cache_bytes = sum(t.numel() * t.element_size() for layer in engine._cache["layers"] for t in layer.values())
    log(f"[13f] float engine: 8 requests ok in {wall:.2f} s, greedy tokens equal serve_sequential for "
        f"all 6 greedy requests (sampled equal: {sum(g.output == w.output for g, w in zip(done, seq) if g.temperature > 0)}/2); "
        f"replayed tick ms median {np.median(ticks):.2f}; the 4-slot x 512 bf16 cache {cache_bytes / 1e6:.1f} MB "
        f"beside phase 3's int8 cache {int8_cache_bytes / 1e6:.1f} MB | {smi}")
    del engine
    cache = fill_cache(Z, cfg, params, [r.prompt for r in done[:4]], device)
    step = torch.tensor([r.output[0] for r in done[:4]], device=device)
    tick = graph_vs_eager(Z, make_decode_step, cfg, params, cache, 512, step, kernels[0], 0, phase=13,
                          tag="float decode tick (4 slots)")
    del cache

    # bucketed prefill: 4 prompts of 32-128 tokens right-padded to PAD_TO,
    # the pads zeros and then garbage
    prompts = [np.asarray(r.prompt) for r in done[:4]]
    lengths = torch.tensor([len(p) for p in prompts], device=device)

    def padded_prefill(fill: int):
        toks = np.full((4, PAD_TO), fill, np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        logits, cache = Z.prefill(params, torch.as_tensor(toks, device=device), cfg,
                                  Z.init_cache(4, 512, cfg, device=device), length=lengths)
        return logits, cache

    pad_logits, pad_cache = padded_prefill(0)
    other_logits, other_cache = padded_prefill(cfg.vocab_size - 1)
    rows_equal = all(torch.equal(a[key][i, :n], b[key][i, :n]) for a, b in zip(pad_cache["layers"], other_cache["layers"])
                     for key in ("k", "v") for i, n in enumerate(lengths.tolist()))
    nxt = pad_logits.argmax(-1)
    d_pad, _ = Z.decode_step(params, nxt, cfg, pad_cache)
    d_other, _ = Z.decode_step(params, nxt, cfg, other_cache)
    if not (torch.equal(pad_logits, other_logits) and rows_equal and torch.equal(d_pad, d_other)):
        raise AssertionError("[13f] the pads' contents reached the logits or the real rows of the cache")
    del other_cache
    worst = [0.0, 0.0]
    for i, p in enumerate(prompts):
        logits, cache = Z.prefill(params, torch.as_tensor(p[None], device=device), cfg,
                                  Z.init_cache(1, 512, cfg, device=device))
        d_exact, _ = Z.decode_step(params, nxt[i:i + 1], cfg, cache)
        for j, (a, b) in enumerate(((pad_logits[i], logits[0]), (d_pad[i], d_exact[0]))):
            if int(a.argmax()) != int(b.argmax()):
                raise AssertionError(f"[13f] padded row {i} ({len(p)} tokens): {'prefill' if j == 0 else 'decode'} "
                                     f"argmax {int(a.argmax())} != exact-length {int(b.argmax())}")
            worst[j] = max(worst[j], float((a - b).abs().max()))
    log(f"[13f] 4 prompts of {[len(p) for p in prompts]} tokens right-padded to {PAD_TO} through "
        f"prefill(length=): logits, the real cache rows and one decode step bitwise equal with the pads "
        f"zeros or garbage; against each exact-length prefill the same argmax, prefill and one decode step, "
        f"max |logit gap| {worst[0]:.4g} / {worst[1]:.4g} (max |logit| {float(pad_logits.abs().max()):.4g}; "
        f"float softmax and P.V sum over {PAD_TO} rows, not the prompt's, and cuBLAS's GEMM depends on M)")
    del params, pad_cache
    torch.cuda.empty_cache()
    return dict(tick, cache_bytes=cache_bytes)


# ---------------------------------------------------------------------------
# phase 14: QAT training -- bit-bert-base W1A1 at full width and depth, then
# served through K3; granite-8b at full width on 4 of its 36 layers
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 32, 128, 30  # 128 tokens: the paper's MNLI-m length
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
TRAIN_SMOKE_BATCH = (4, 64)  # [14b]
RESUME_BATCH, RESUME_CUT, RESUME_STEPS = 8, 3, 6  # [14c]
CLI_STEPS, CLI_EVERY = 8, 4  # [14d]: the child's run and checkpoint interval
CLI_TRAIN_ARGS = ["--steps", str(CLI_STEPS), "--batch", "8", "--seq", str(TRAIN_SEQ), "--lr", "1e-3",
                  "--ckpt-every", str(CLI_EVERY)]
CLI_TIMEOUT_S = 300
# [14f]: 8 B latents need ~131 GB with Adam, so 4 of granite-8b's 36 layers
GRANITE_TRAIN_LAYERS, GRANITE_TRAIN_BATCH, GRANITE_TRAIN_SEQ, GRANITE_TRAIN_STEPS = 4, 4, 512, 5
# [14b]: a train step on the card against the CPU's (tests/test_torch_cuda.py
# holds the same): cuBLAS sums its float32 products in its own order, and at
# W1A1 an ulp can cross a quantizer's bucket edge.  TF32 would show as far
# larger gaps; the package turns it off and [14b] checks that it is off.
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-2
# Stated bounds (ROADMAP section 3), (loss, gradient leaf): where a float32
# result on the card rounds to bf16 across a tie from the CPU's, an 8-bit
# per-tensor fake quantizer moves that element a whole bucket and the
# layers after it carry the step.  gemma3's 8 smoke layers: every layer's
# forward is bitwise the CPU's for two of four batches; in [14b]'s an
# element of layer 5 flips (loss 2.3e-5, a gradient leaf 2.2e-2), in
# tests/test_torch_cuda.py's the loss is 8.4e-5 off and a leaf 0.126; with
# qk-norm off [14b]'s batch stays bitwise through every layer.
# whisper-tiny with frames: its encoder runs in the frames' float32.
TRAIN_BOUNDS = {"gemma3-27b": (2e-4, 2e-1), "whisper-tiny": (1e-5, 2e-1)}
# [14e]: the all-positions serving forward's last row against Z.prefill's
# logits, of their largest magnitude (float32 products over 768, summed in
# another order)
SERVED_LAST_ROW_TOL = 1e-5


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _trees_equal(a, b) -> bool:
    from repro_torch.core.tree import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _card_vs_cpu_step(Z, TL, cfg, batch: dict, device, tcfg):
    """One smoke train step from seed-0 params on the CPU and on the card:
    (loss gap, {leaf: gradient gap of its scale}, leaves bit for bit)."""
    from repro_torch.core.tree import leaves, leaves_with_paths

    params = Z.init_params(0, cfg, device="cpu")
    runs = [TL.value_and_grad(_to_device(params, d), {k: torch.as_tensor(v).to(d) for k, v in batch.items()},
                              cfg, tcfg) for d in ("cpu", device)]
    (m_cpu, g_cpu), (m_dev, g_dev) = runs
    loss_gap = abs(float(m_dev["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    gaps = {p: float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for (p, a), b in zip(leaves_with_paths(g_dev), leaves(g_cpu))}
    equal = sum(torch.equal(a.cpu(), b) for a, b in zip(leaves(g_dev), leaves(g_cpu)))
    return loss_gap, gaps, equal, (float(m_dev["loss"]), float(m_cpu["loss"]))


def serving_logits(Z, params, tokens, cfg, device):
    """``Z.prefill``'s forward (an int8 cache, the packed linears through
    the config's backend) with the logits of every position, (B, S, V)
    float32, and its cache: bit-bert is an encoder, so each position's
    argmax is read from one pass.  [14e] holds the cache bitwise to
    ``Z.prefill``'s and the last row to its logits (the unembed's product
    over S rows, not one, sums in another order)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    cache = Z.init_cache(b, s, cfg, device=device)
    positions = torch.arange(s, device=device).broadcast_to(b, s)
    x = Z._embed_inputs(params, tokens, cfg, positions)
    x, _ = T.stack_apply(params["layers"], x, cfg, positions, cache["layers"])
    return L.unembed(params, L.rmsnorm(params["final_norm"], x, cfg.norm_eps), cfg.tie_embeddings), cache


def _timed_steps(step, params, opt, pipe, n: int):
    losses, times = [], []
    for _ in range(n):
        batch = pipe.next()
        t = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
    return params, opt, losses, times


def train_models(Z, bert_cfg, granite_cfg, device, ops, ref, kernels, smi, workdir: Path,
                 child_args=("--arch", "bit-bert-base")) -> dict:
    """Phase 14.  Returns K3's ``trained`` entry: its launches in [14e]'s
    ``Z.prefill`` of the trained model.  The training numbers go on a line
    of their own (``[14] training numbers``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.smoke import smoke_variant
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault_tolerance as FT
    from repro_torch.runtime import train_loop as TL

    def stream(batch, seq, seed=0, vocab=bert_cfg.vocab_size):
        return TokenPipeline(DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed))

    t_phase = time.perf_counter()
    cfg = bert_cfg
    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(**TRAIN_OPT), remat=True)

    # (a) bit-bert-base W1A1 trained at full width and depth
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = TL.init_train_state(0, cfg, device=device)
    n_latent = sum(x.numel() for x in leaves(params))
    step = TL.make_train_step(cfg, tcfg, device=device)
    pipe = stream(TRAIN_BATCH, TRAIN_SEQ)
    _zero(kernels)
    params, opt, losses, times = _timed_steps(step, params, opt, pipe, TRAIN_STEPS)
    launched = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[14a] losses not finite or not falling: {losses}")
    if any(launched):
        raise AssertionError(f"[14a] the training step launched serving kernels {launched}")
    steady = times[1:]
    p50, p99 = float(np.median(steady)), float(np.percentile(steady, 99))
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3)
    log(f"[14a] {cfg.name} W1A{cfg.quant.act_bits} QAT: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_latent / 1e6:.1f} M latents; {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, AdamW {TRAIN_OPT}, remat on; loss {losses[0]:.4f} -> {losses[-1]:.4f} (min "
        f"{min(losses):.4f}); every loss finite, the last below the first | {smi}")
    log(f"[14a] step ms: first {times[0]:.1f}, then p50 {p50:.2f}, p99 {p99:.2f} (min {min(steady):.2f}); "
        f"{tokens_s:.0f} trained tokens/s at p50; peak allocated {peak / 1e9:.3f} GB; losses "
        + " ".join(f"{x:.3f}" for x in losses))
    nxt = pipe._batch_at(pipe.cursor)
    prof = profile_forward(lambda: step(params, opt, nxt))
    report_profile(f"bit-bert-base train step ({TRAIN_BATCH} x {TRAIN_SEQ})", *prof, phase=14, wall_ms=p50)
    trained = dict(train_steps=TRAIN_STEPS, train_tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
                   train_first_loss=losses[0], train_last_loss=losses[-1], train_step_p50_ms=p50,
                   train_step_p99_ms=p99, train_tokens_per_s=tokens_s, train_peak_bytes=peak,
                   train_busy_ms=prof[1], train_idle_share=1 - prof[1] / p50, train_device_ops=prof[2])

    # (b) a smoke step on the card against the CPU's
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError("[14b] TF32 or reduced-precision reductions are on for the train step")
    from repro_torch.configs import get_config

    # bit-bert and granite held to TRAIN_*_TOL, gemma3 to its TRAIN_BOUNDS
    for scfg in (smoke_variant(cfg), smoke_variant(granite_cfg), smoke_variant(get_config("gemma3-27b"))):
        sbatch = stream(*TRAIN_SMOKE_BATCH, seed=1, vocab=scfg.vocab_size).next()
        loss_gap, gaps, equal, (dev_loss, cpu_loss) = _card_vs_cpu_step(Z, TL, scfg, sbatch, device, tcfg)
        loss_tol, grad_tol = TRAIN_BOUNDS.get(scfg.name.removesuffix("-smoke"), (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL))
        worst = max(gaps, key=gaps.get)
        if loss_gap > loss_tol or gaps[worst] > grad_tol:
            raise AssertionError(f"[14b] {scfg.name} card vs CPU: loss gap {loss_gap:.3g}, gradient gap "
                                 f"{gaps[worst]:.3g} at {worst}")
        log(f"[14b] {scfg.name} ({scfg.n_layers} layers) step ({TRAIN_SMOKE_BATCH[0]} x {TRAIN_SMOKE_BATCH[1]}) "
            f"on the card against the CPU: loss {dev_loss:.7f} vs {cpu_loss:.7f} (relative gap {loss_gap:.3g}); "
            f"gradient leaves: {equal}/{len(gaps)} bit for bit, largest gap {gaps[worst]:.3g} of a leaf's largest "
            f"magnitude ({worst}; held to {loss_tol} / {grad_tol})")
        key = scfg.name.split("-")[0]
        trained.update({f"card_vs_cpu_loss_gap_{key}": loss_gap, f"card_vs_cpu_grad_gap_{key}": gaps[worst]})

    # (c) 6 straight steps against 3 + checkpoint + restore + 3, on the card
    def runner(name, total, every):
        return FT.TrainingRunner(
            TL.make_train_step(cfg, tcfg, device=device), stream(RESUME_BATCH, TRAIN_SEQ, seed=2),
            CheckpointManager(str(workdir / name), keep=1),
            FT.RunnerConfig(total_steps=total, checkpoint_every=every, log_every=10**6), log_fn=lambda *_: None)

    p0, o0 = TL.init_train_state(1, cfg, device=device)
    pa, oa, _ = runner("c_straight", RESUME_STEPS, 10**6).run(p0, o0)
    t = time.perf_counter()
    runner("c_cut", RESUME_CUT, RESUME_CUT).run(p0, o0)
    save_s = time.perf_counter() - t
    resumed = runner("c_cut", RESUME_STEPS, 10**6)
    t = time.perf_counter()
    start, pr, orr = resumed.try_restore(p0, o0)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t) * 1e3
    pb, ob, _ = resumed.run(pr, orr, start)
    ckpt_bytes = _dir_bytes(workdir / "c_cut" / _committed(workdir / "c_cut")[-1])
    if start != RESUME_CUT or not (_trees_equal(pa, pb) and _trees_equal(oa, ob)):
        raise AssertionError(f"[14c] resumed at {start}: params equal {_trees_equal(pa, pb)}, "
                             f"optimizer state equal {_trees_equal(oa, ob)}")
    log(f"[14c] {RESUME_STEPS} straight steps ({RESUME_BATCH} x {TRAIN_SEQ}) equal {RESUME_CUT} + checkpoint + "
        f"restore + {RESUME_STEPS - RESUME_CUT}, params and AdamW state bit for bit (no deterministic mode "
        f"needed); the {RESUME_CUT} steps with their checkpoint {save_s:.2f} s, the checkpoint "
        f"{ckpt_bytes / 1e9:.3f} GB, its restore {restore_ms:.0f} ms")
    trained.update(checkpoint_bytes=ckpt_bytes, restore_ms=restore_ms)
    del pa, oa, pb, ob, pr, orr, p0, o0

    # (d) the CLI at full width, SIGTERMed after its first checkpoint
    ckpt = workdir / "d"
    argv = [*child_args, *CLI_TRAIN_ARGS, "--ckpt-dir", str(ckpt), "--device", device.type]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    first = ckpt / f"step_{CLI_EVERY:09d}" / "_COMMITTED"
    t = time.perf_counter()
    with open(workdir / "train_child.log", "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            while time.perf_counter() - t < CLI_TIMEOUT_S and proc.poll() is None and not first.exists():
                time.sleep(0.02)
            alive = proc.poll() is None
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=CLI_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    text = (workdir / "train_child.log").read_text()
    stopped = CheckpointManager(str(ckpt)).latest_step()
    if not alive or proc.returncode != 0 or "exiting after preemption checkpoint" not in text \
            or stopped is None or not CLI_EVERY <= stopped < CLI_STEPS:
        raise AssertionError(f"[14d] child: alive at the signal {alive}, rc {proc.returncode}, last "
                             f"checkpoint {stopped}; its output:\n{text[-3000:]}")
    cut_s = time.perf_counter() - t
    t = time.perf_counter()
    again = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    relaunch_s = time.perf_counter() - t
    if again.returncode != 0 or f"resumed from step {stopped}" not in again.stdout:
        raise AssertionError(f"[14d] relaunch rc {again.returncode}:\n{again.stdout[-3000:]}\n{again.stderr[-2000:]}")
    ccfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=max(CLI_STEPS // 10, 1),
                                                      total_steps=CLI_STEPS))
    cp, co = TL.init_train_state(0, cfg, device=device)  # the child's model is ``cfg``, seed 0
    cp, co, _, _ = _timed_steps(TL.make_train_step(cfg, ccfg, device=device), cp, co,
                                stream(8, TRAIN_SEQ), CLI_STEPS)
    _, tree, extras = CheckpointManager(str(ckpt)).restore(CLI_STEPS, like={"params": cp, "opt": co})
    if not (_trees_equal(tree["params"], cp) and _trees_equal(tree["opt"], co)) \
            or extras["pipeline"]["cursor"] != CLI_STEPS:
        raise AssertionError("[14d] the resumed CLI run's params differ from an uninterrupted run's")
    log(f"[14d] python -m repro_torch.launch.train {' '.join(argv[:2])} ({CLI_STEPS} steps of 8 x {TRAIN_SEQ}) "
        f"SIGTERMed once step {CLI_EVERY}'s checkpoint committed ({cut_s:.1f} s to its exit): it checkpointed "
        f"step {stopped} and exited 0; relaunched ({relaunch_s:.1f} s), it resumed from step {stopped} and its "
        f"step-{CLI_STEPS} params and AdamW state equal an uninterrupted run's bit for bit")
    del cp, co, tree

    # (e) the trained latents packed and served through K3 (W1A1)
    serve_cfg = with_backend(cfg, "pallas")
    sp = Z.prepare_serving_params(params, serve_cfg)
    prompt = torch.as_tensor(stream(1, TRAIN_SEQ, seed=5).next()["tokens"], device=device).to(torch.int64)
    per_forward = BERT_SITES_PER_LAYER * cfg.n_layers

    def serve_prefill():
        return Z.prefill(sp, prompt, serve_cfg, Z.init_cache(1, TRAIN_SEQ, serve_cfg, device=device))

    torch.cuda.synchronize()
    _zero(kernels)
    last, cache = serve_prefill()
    torch.cuda.synchronize()
    launched = _counts(kernels)
    if launched != [0, 0, per_forward, 0]:
        raise AssertionError(f"[14e] the trained model's prefill launched K1-K4 {launched}; expected K3 = "
                             f"{per_forward} and no other")
    plain = lambda a, b: ref.popcount_qmm_ref(a, b, 32 * a.shape[1])  # noqa: E731
    with mock.patch.object(ops._pq, "popcount_qmm", plain):
        last_plain, cache_plain = serve_prefill()
    if not torch.equal(last, last_plain) or not Z.caches_equal(cache, cache_plain):
        raise AssertionError("[14e] the trained model's prefill (logits, cache) differs with K3 swapped for "
                             "its plain version")
    if not bool(torch.isfinite(last).all()) or last.shape != (1, cfg.vocab_size):
        raise AssertionError("[14e] served logits not finite or of the wrong shape")
    served, served_cache = serving_logits(Z, sp, prompt, serve_cfg, device)
    last_gap = float((served[:, -1] - last).abs().max()) / float(last.abs().max())
    if not Z.caches_equal(served_cache, cache) or last_gap > SERVED_LAST_ROW_TOL:
        raise AssertionError(f"[14e] the all-positions serving forward differs from Z.prefill: cache equal "
                             f"{Z.caches_equal(served_cache, cache)}, last row {last_gap:.3g} of its scale")
    with torch.no_grad():
        qat, _ = Z.forward_logits(params, prompt, cfg)
    share_qat = float((qat.argmax(-1) == prompt).float().mean())
    share_served = float((served.argmax(-1) == prompt).float().mean())
    agree = float((qat.argmax(-1) == served.argmax(-1)).float().mean())
    log(f"[14e] trained latents packed (prepare_serving_params) and a {TRAIN_SEQ}-token Z.prefill served at "
        f"W1A1: popcount_qmm launches {launched[2]} = {BERT_SITES_PER_LAYER} x {cfg.n_layers}, logits and "
        f"cache bitwise equal with popcount_qmm swapped for popcount_qmm_ref; argmax == input token at "
        f"{share_qat:.4f} of positions under the QAT forward, {share_served:.4f} served (the all-positions "
        f"serving forward: its cache bitwise Z.prefill's, its last row {last_gap:.3g} of the logits' scale "
        f"from Z.prefill's; the two argmaxes agree at {agree:.4f}; a reading: PERF.md section 7)")
    trained.update(argmax_share_qat=share_qat, argmax_share_served=share_served, argmax_agree=agree)
    k3_trained = dict(launches=launched[2])
    del params, opt, sp, step, served, served_cache, last, last_plain, cache, cache_plain, qat
    torch.cuda.empty_cache()

    # (f) granite-8b at full width, 4 of its 36 layers
    gcfg = dataclasses.replace(granite_cfg, n_layers=GRANITE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    gp, go = TL.init_train_state(0, gcfg, device=device)
    n_latent = sum(x.numel() for x in leaves(gp))
    gstep = TL.make_train_step(gcfg, TL.TrainConfig(optimizer=adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=GRANITE_TRAIN_STEPS)), device=device)
    gpipe = stream(GRANITE_TRAIN_BATCH, GRANITE_TRAIN_SEQ, vocab=gcfg.vocab_size)
    gp, go, glosses, gtimes = _timed_steps(gstep, gp, go, gpipe, GRANITE_TRAIN_STEPS)
    gpeak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(glosses)):
        raise AssertionError(f"[14f] granite losses not finite: {glosses}")
    g50 = float(np.median(gtimes[1:]))
    log(f"[14f] {granite_cfg.name} at full width (d_model {gcfg.d_model}, d_ff {gcfg.d_ff}, vocab "
        f"{gcfg.vocab_size}) with {GRANITE_TRAIN_LAYERS} of its {granite_cfg.n_layers} layers "
        f"({n_latent / 1e9:.3f} B latents; all 36 would need ~131 GB with Adam): {GRANITE_TRAIN_STEPS} steps "
        f"of {GRANITE_TRAIN_BATCH} x {GRANITE_TRAIN_SEQ}, losses " + " ".join(f"{x:.4f}" for x in glosses)
        + f", all finite; step ms first {gtimes[0]:.1f}, then median {g50:.2f} ("
        + ", ".join(f"{x:.1f}" for x in gtimes[1:]) + f"); {GRANITE_TRAIN_BATCH * GRANITE_TRAIN_SEQ / (g50 / 1e3):.0f} "
        f"trained tokens/s; peak allocated {gpeak / 1e9:.2f} GB | {smi}")
    trained.update(granite_layers=GRANITE_TRAIN_LAYERS, granite_step_ms=g50, granite_peak_bytes=gpeak)
    del gp, go, gstep
    torch.cuda.empty_cache()
    log("[14] training numbers: " + json.dumps(trained))
    log(f"[14] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return k3_trained


# ---------------------------------------------------------------------------
# phase 15: QAT of the MoE / MLA and recurrent families -- deepseek-v2-lite-16b
# (the "Md" prefix and 2 of 26 "Mm" layers), recurrentgemma-2b (5 of 26
# layers) and mamba2-130m (all 24) at full width; the trained deepseek and
# mamba2 served through K1
# ---------------------------------------------------------------------------

# [15a] / [15c]: (layers, batch, seq, steps).  deepseek-v2-lite: 3 layers and
# both 102,400 x 2,048 tables are ~1.67 B latents, ~31 B each with AdamW, the
# update's second set and the activations (52 GB on an H100); 4 x 512 tokens
# give each of the 64 experts a capacity of 240 rows (factor 1.25).
# recurrentgemma-2b: its (r, r) prefix and one (r, r, l) period, ~1.1 B
# latents (the 256,000-row tied table is 0.66 B of them).
DEEPSEEK_TRAIN = (3, 4, 512, 5)
RECURRENTGEMMA_TRAIN = (5, 4, 512, 5)
MAMBA2_TRAIN = (None, 8, 1024, 20)  # full depth
TRAIN15_OPT = dict(lr=1e-3, warmup_steps=1)
# [15d]: the trained models served: a 128-token prefill and 4 decode steps
SERVE15_PROMPT, SERVE15_STEPS, SERVE15_MAX_LEN = 128, 4, 256
# [15b]: the smoke variants held card against CPU, one step of 4 x 64
TRAIN15_SMOKE = ("deepseek-v2-lite-16b", "deepseek-v3-671b", "recurrentgemma-2b", "mamba2-130m")


def _route_spy(M, seen: list):
    """A stand-in for ``moe._route`` that records each call's experts (on
    the host) and a stand-in for ``moe._dispatch`` that records ``keep``."""
    route, dispatch = M._route, M._dispatch

    def spy_route(*args, **kwargs):
        out = route(*args, **kwargs)
        seen.append({"experts": out[1].detach().cpu()})
        return out

    def spy_dispatch(*args, **kwargs):
        out = dispatch(*args, **kwargs)
        seen[-1].update(keep=out[2].cpu(), dest=out[3].cpu())
        return out

    return spy_route, spy_dispatch


def _routing(M, e, fn) -> dict:
    """Run ``fn`` with the router and dispatch recorded; the routes it
    dropped at capacity (share over every MoE layer) and the most loaded
    expert's routes (the largest over the layers, before the capacity cut)."""
    seen = []
    spy_route, spy_dispatch = _route_spy(M, seen)
    with mock.patch.object(M, "_route", spy_route), mock.patch.object(M, "_dispatch", spy_dispatch):
        out = fn()
    routes = sum(r["keep"].numel() for r in seen)
    dropped = sum(int((~r["keep"]).sum()) for r in seen)
    loads = [torch.bincount(r["experts"].reshape(-1), minlength=e.n_routed) for r in seen]
    return dict(out=out, layers=len(seen), routes=routes, dropped_share=dropped / max(routes, 1),
                max_expert_routes=max(int(x.max()) for x in loads),
                mean_expert_routes=routes / max(len(seen), 1) / e.n_routed)


def _train_run(Z, TL, adamw, cfg, device, batch: int, seq: int, steps: int, stream, tag: str, smi: str,
               kernels, phase: int = 15):
    """Train ``cfg`` from seed 0 for ``steps`` steps of ``batch`` x ``seq``
    on the card (AdamW, remat on), time each step, profile one more.
    ``stream(batch, seq, vocab=)`` gives the batches (with a frontend
    where the model takes one).  Returns (params, losses, readings)."""
    from repro_torch.core.tree import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = TL.init_train_state(0, cfg, device=device)
    n_latent = sum(x.numel() for x in leaves(params))
    step = TL.make_train_step(cfg, TL.TrainConfig(optimizer=adamw.AdamWConfig(total_steps=steps, **TRAIN15_OPT)),
                              device=device)
    pipe = stream(batch, seq, vocab=cfg.vocab_size)
    _zero(kernels)
    losses, auxes, times = [], [], []
    for _ in range(steps):
        b = pipe.next()
        t = time.perf_counter()
        params, opt, metrics = step(params, opt, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux"]))
    peak = torch.cuda.max_memory_allocated()
    if any(_counts(kernels)):
        raise AssertionError(f"[{phase}] the {tag} training step launched serving kernels {_counts(kernels)}")
    if not all(np.isfinite(losses + auxes)):
        raise AssertionError(f"[{phase}] {tag} losses not finite: {losses} {auxes}")
    steady = times[1:]
    p50, p99 = float(np.median(steady)), float(np.percentile(steady, 99))
    tokens_s = batch * seq / (p50 / 1e3)
    r = dict(layers=cfg.n_layers, latents=n_latent, steps=steps, tokens_per_step=batch * seq,
             first_loss=losses[0], last_loss=losses[-1], aux_first=auxes[0], aux_last=auxes[-1],
             step_p50_ms=p50, step_p99_ms=p99, tokens_per_s=tokens_s, peak_bytes=peak)
    log(f"{tag}: {cfg.n_layers} layers ({''.join(cfg.layer_kinds)}), d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_latent / 1e9:.3f} B latents; {steps} steps of {batch} x {seq}, AdamW lr "
        f"{TRAIN15_OPT['lr']}, remat on; loss " + " ".join(f"{x:.4f}" for x in losses) + "; aux "
        + " ".join(f"{x:.4f}" for x in auxes) + f"; step ms first {times[0]:.1f}, then p50 {p50:.2f}, p99 "
        f"{p99:.2f}; {tokens_s:.0f} trained tokens/s; peak allocated {peak / 1e9:.3f} GB | {smi}")
    nxt = pipe._batch_at(pipe.cursor)
    prof = profile_forward(lambda: step(params, opt, nxt))
    report_profile(f"{tag} train step ({batch} x {seq})", *prof, phase=phase, wall_ms=p50)
    r.update(busy_ms=prof[1], device_ops=prof[2], idle_share=1 - prof[1] / p50)
    del opt, step
    torch.cuda.empty_cache()
    return params, losses, r


def _serve_trained(Z, cfg, params, device, ops, ref, kernels, per_prefill: int, per_decode: int, tag: str,
                   tokens: np.ndarray):
    """Pack trained latents and serve a prefill of ``tokens`` and
    SERVE15_STEPS greedy decode steps on ``pallas``: K1's launches against
    the forward's sites, and logits and every cache leaf bitwise to the same
    run with K1 swapped for its plain version.  Returns (K1's launches, the
    serving params)."""
    scfg = with_backend(cfg, "pallas")
    served = Z.prepare_serving_params(params, scfg)
    prompt = torch.as_tensor(tokens, device=device)

    def run():
        cache = Z.init_cache(1, SERVE15_MAX_LEN, scfg, device=device)
        logits, cache = Z.prefill(served, prompt, scfg, cache)
        out = [logits]
        for _ in range(SERVE15_STEPS):
            logits, cache = Z.decode_step(served, out[-1].argmax(-1), scfg, cache)
            out.append(logits)
        return out, cache

    torch.cuda.synchronize()
    _zero(kernels)
    got, cache = run()
    torch.cuda.synchronize()
    launched = _counts(kernels)
    want = per_prefill + SERVE15_STEPS * per_decode
    if launched != [want, 0, 0, 0]:
        raise AssertionError(f"[15d] {tag}: K1-K4 launches {launched}; expected K1 = {want}")
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, plain_cache = run()
    if not all(torch.equal(a, b) for a, b in zip(got, plain)) or not Z.caches_equal(cache, plain_cache):
        raise AssertionError(f"[15d] {tag}: logits or cache differ with K1 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in got):
        raise AssertionError(f"[15d] {tag}: served logits not finite or of the wrong shape")
    log(f"[15d] {tag} trained latents packed (prepare_serving_params, pallas) and served: a "
        f"{prompt.shape[1]}-token Z.prefill and {SERVE15_STEPS} decode steps, binary_qmm launches {want} = "
        f"{per_prefill} + {SERVE15_STEPS} x {per_decode}; logits and every cache leaf bitwise equal with "
        f"binary_qmm swapped for binary_qmm_ref; greedy tokens " + str([int(x.argmax()) for x in got]))
    return want, served


def train_families(Z, deepseek_cfg, recurrent_cfgs, device, ops, ref, kernels, smi, workdir: Path):
    """Phase 15.  Returns K1's entries for the trained models served in
    [15d] and the training numbers, which also go on a line of their own
    (``[15] training numbers``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_variant
    from repro_torch.core.tree import leaves, leaves_with_paths
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import moe as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault_tolerance as FT
    from repro_torch.runtime import train_loop as TL

    def stream(batch, seq, seed=0, vocab=deepseek_cfg.vocab_size):
        return TokenPipeline(DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed))

    t_phase = time.perf_counter()
    numbers, k1 = {}, {}

    # (a) deepseek-v2-lite-16b at full width: the "Md" prefix + 2 "Mm" layers
    layers, batch, seq, steps = DEEPSEEK_TRAIN
    dcfg = dataclasses.replace(deepseek_cfg, n_layers=layers)
    e = dcfg.moe
    prompt = stream(1, SERVE15_PROMPT, seed=5).next()["tokens"].astype(np.int64)
    per_prefill, per_decode = k1_per_forward(dcfg, True), k1_per_forward(dcfg, False)
    scfg = with_backend(dcfg, "pallas")

    def prefill_routing(served):  # the prefill [15d] serves, its routes recorded
        return _routing(M, e, lambda: Z.prefill(served, torch.as_tensor(prompt, device=device), scfg,
                                                Z.init_cache(1, SERVE15_MAX_LEN, scfg, device=device)))

    # the untrained model (seed 0, [15a]'s start) routes the same prompt
    untrained = prefill_routing(Z.prepare_serving_params(Z.init_params(0, dcfg, device=device), scfg))
    torch.cuda.empty_cache()
    capacity = int(max(1, round(e.capacity_factor * batch * seq * e.top_k / e.n_routed)))
    params, losses, r = _train_run(Z, TL, adamw, dcfg, device, batch, seq, steps, stream,
                                   f"[15a] {deepseek_cfg.name} W1A8 QAT", smi, kernels)
    if not r["aux_last"] > 0:
        raise AssertionError(f"[15a] the balance loss is not positive: {r}")
    log(f"[15a] {dcfg.name}: {e.n_routed} routed experts top-{e.top_k} + {e.n_shared} shared, capacity "
        f"{capacity} rows an expert at {batch * seq} tokens; balance loss {r['aux_first']:.4f} -> "
        f"{r['aux_last']:.4f} (1.0 at a uniform load)")
    numbers["deepseek"] = dict(r, capacity=capacity)

    # (d) the trained deepseek served through K1, and its routing
    launches, served = _serve_trained(Z, dcfg, params, device, ops, ref, kernels, per_prefill, per_decode,
                                      dcfg.name, prompt)
    k1["trained_deepseek"] = dict(launches=launches)
    trained = prefill_routing(served)
    for key, rt in (("untrained", untrained), ("trained", trained)):
        numbers["deepseek"][f"routing_{key}"] = {k: v for k, v in rt.items() if k != "out"}
    log(f"[15d] routing of the {SERVE15_PROMPT}-token prefill over its {trained['layers']} MoE layers "
        f"({e.n_routed} experts top-{e.top_k}, capacity "
        f"{int(max(1, round(e.capacity_factor * SERVE15_PROMPT * e.top_k / e.n_routed)))} an expert): untrained "
        f"{untrained['dropped_share']:.4f} of {untrained['routes']} routes dropped at capacity, the most loaded "
        f"expert {untrained['max_expert_routes']} routes (mean {untrained['mean_expert_routes']:.1f}); after "
        f"{steps} steps {trained['dropped_share']:.4f} dropped, the most loaded {trained['max_expert_routes']} "
        f"(a reading: PERF.md section 7)")
    del params, served, untrained, trained
    torch.cuda.empty_cache()

    # (c) recurrentgemma-2b on 5 of its 26 layers, mamba2-130m at full depth
    for rcfg in recurrent_cfgs:
        spec = RECURRENTGEMMA_TRAIN if rcfg.ssm is None else MAMBA2_TRAIN
        layers, batch, seq, steps = spec
        cfg = rcfg if layers is None else dataclasses.replace(rcfg, n_layers=layers)
        params, losses, r = _train_run(Z, TL, adamw, cfg, device, batch, seq, steps, stream,
                                       f"[15c] {rcfg.name} W1A8 QAT", smi, kernels)
        key = rcfg.name.split("-")[0]
        if cfg.ssm is not None:
            if not losses[-1] < losses[0]:
                raise AssertionError(f"[15c] {cfg.name} loss did not fall: {losses}")
            per = recurrent_k1_per_forward(cfg)
            rtoks = stream(1, SERVE15_PROMPT, seed=6, vocab=cfg.vocab_size).next()["tokens"].astype(np.int64)
            launches, _ = _serve_trained(Z, cfg, params, device, ops, ref, kernels, per, per, cfg.name, rtoks)
            k1[f"trained_{key}"] = dict(launches=launches)
        numbers[key] = r
        del params
        torch.cuda.empty_cache()

    # (b) one smoke step on the card against the CPU, routes first
    tcfg = TL.TrainConfig()
    for name in TRAIN15_SMOKE:
        scfg = smoke_variant(get_config(name))
        sparams = Z.init_params(0, scfg, device="cpu")
        stoks = torch.from_numpy(stream(*TRAIN_SMOKE_BATCH, seed=1, vocab=scfg.vocab_size).next()["tokens"])
        runs = []
        for d in ("cpu", device):
            seen = []
            spy_route, spy_dispatch = _route_spy(M, seen)
            with mock.patch.object(M, "_route", spy_route), mock.patch.object(M, "_dispatch", spy_dispatch):
                runs.append((seen, *TL.value_and_grad(_to_device(sparams, d), {"tokens": stoks.to(d)}, scfg, tcfg)))
        (r_cpu, m_cpu, g_cpu), (r_dev, m_dev, g_dev) = runs
        moved = [int((a["experts"] != b["experts"]).sum()) for a, b in zip(r_cpu, r_dev)]
        same_dispatch = all(torch.equal(a["keep"], b["keep"]) and torch.equal(a["dest"], b["dest"])
                            for a, b in zip(r_cpu, r_dev))
        if len(r_cpu) != len(r_dev) or any(moved) or not same_dispatch:
            raise AssertionError(f"[15b] {scfg.name}: routes differ card vs CPU ({moved} per router call)")
        loss_gap = abs(float(m_dev["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
        gaps = {p: float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for (p, a), b in zip(leaves_with_paths(g_dev), leaves(g_cpu))}
        worst = max(gaps, key=gaps.get)
        equal = sum(torch.equal(a.cpu(), b) for a, b in zip(leaves(g_dev), leaves(g_cpu)))
        if loss_gap > TRAIN_LOSS_RTOL or gaps[worst] > TRAIN_GRAD_TOL:
            raise AssertionError(f"[15b] {scfg.name} card vs CPU: loss gap {loss_gap:.3g}, gradient gap "
                                 f"{gaps[worst]:.3g} at {worst}")
        log(f"[15b] {scfg.name} ({scfg.n_layers} layers) step ({TRAIN_SMOKE_BATCH[0]} x {TRAIN_SMOKE_BATCH[1]}) "
            f"on the card against the CPU: {len(r_cpu)} router calls, routes, keep and dest equal; loss "
            f"{float(m_dev['loss']):.7f} vs {float(m_cpu['loss']):.7f} (relative gap {loss_gap:.3g}), aux "
            f"{float(m_dev['aux']):.7f} vs {float(m_cpu['aux']):.7f}; gradient leaves: {equal}/{len(gaps)} bit for "
            f"bit, largest gap {gaps[worst]:.3g} of a leaf's largest magnitude ({worst}; held to "
            f"{TRAIN_LOSS_RTOL} / {TRAIN_GRAD_TOL})")
        numbers[f"card_vs_cpu_{name.split('-')[0]}_{name.split('-')[1]}"] = dict(loss_gap=loss_gap,
                                                                                grad_gap=gaps[worst])

    # (e) 6 straight steps against 3 + checkpoint + restore + 3 on the
    # deepseek-v2-lite smoke model (rank-3 experts, aux in the metrics)
    scfg = smoke_variant(deepseek_cfg)

    def runner(name, total, every):
        return FT.TrainingRunner(
            TL.make_train_step(scfg, TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                                                total_steps=6)), device=device),
            stream(4, 64, seed=2, vocab=scfg.vocab_size), CheckpointManager(str(workdir / name), keep=1),
            FT.RunnerConfig(total_steps=total, checkpoint_every=every, log_every=1), log_fn=lambda *_: None)

    p0, o0 = TL.init_train_state(1, scfg, device=device)
    pa, oa, hist = runner("e_straight", 6, 10**6).run(p0, o0)
    runner("e_cut", 3, 3).run(p0, o0)
    resumed = runner("e_cut", 6, 10**6)
    start, pr, orr = resumed.try_restore(*TL.init_train_state(2, scfg, device=device))
    pb, ob, hist_b = resumed.run(pr, orr, start)
    if start != 3 or not (_trees_equal(pa, pb) and _trees_equal(oa, ob)) or [h["aux"] for h in hist[3:]] != \
            [h["aux"] for h in hist_b]:
        raise AssertionError(f"[15e] resumed at {start}: params equal {_trees_equal(pa, pb)}, optimizer state "
                             f"equal {_trees_equal(oa, ob)}")
    log(f"[15e] {scfg.name}: 6 straight steps (4 x 64) equal 3 + checkpoint + restore + 3, params (rank-3 "
        f"experts) and AdamW state bit for bit, the aux metric step by step ("
        + ", ".join(f"{h['aux']:.5f}" for h in hist) + ")")
    log("[15] training numbers: " + json.dumps(numbers))
    log(f"[15] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return k1, numbers


# ---------------------------------------------------------------------------
# phase 16: QAT of the encoder frontends -- whisper-tiny whole (its encoder
# over 1,500 frames, cross-attention) and internvl2-2b at full width (patch
# rows spliced over the prompt) -- served through K1; the bf16 scores /
# logits variants
# ---------------------------------------------------------------------------

# [16a] / [16b]: (layers, batch, seq, steps).  whisper-tiny: 8 x 448 tokens
# (its max_seq) over 8 x 1,500 frames a step.  internvl2-2b at full depth:
# ~63 M latents a layer plus ~381 M in its two 92,553 x 2,048 tables and the
# stub projection, 1.89 B in all, 53.4 GB at its peak on an H100 (28.2 B a
# latent; scripts/card_train_checks.py depth).
WHISPER_TRAIN = (None, 8, 448, 20)
INTERNVL_TRAIN = (None, 4, 512, 5)
# [16c]: the trained models served: internvl2's image prefill (its 256
# patch positions + INTERNVL_TEXT tokens) through make_prefill; whisper's
# batch-4 transcription, make_prefill + SERVE16_STEPS make_decode_step calls
SERVE16_STEPS = 8
# [16d]: smoke steps card against CPU, the encoder families with a frontend
# and granite-8b with both bf16 variants, held to TRAIN_LOSS_RTOL /
# TRAIN_GRAD_TOL but where TRAIN_BOUNDS states another bound
BF16_VARIANTS = dict(attn_scores_dtype="bf16", logits_dtype="bf16")
TRAIN16_SMOKE = (("whisper-tiny", {}), ("internvl2-2b", {}), ("granite-8b", BF16_VARIANTS))
# [16e]: the bf16 variants at full width, as readings beside [15c]'s and
# [16a]'s float32 runs
BF16_READING_STEPS = 5


def _frontend_stream(cfg, TokenPipeline, DataConfig):
    """``stream(batch, seq, seed, vocab)`` of token batches that also carry
    float32 stub frontends (``encoder.n_positions`` x ``d_input``)."""
    enc = cfg.encoder

    def stream(batch, seq, seed=0, vocab=cfg.vocab_size):
        return TokenPipeline(DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed,
                                        frontend_positions=enc.n_positions,
                                        frontend_dim=enc.d_input or cfg.d_model))

    return stream


def _serve_trained_internvl(Z, cfg, params, device, ops, ref, kernels, make_prefill) -> int:
    """[16c] internvl2's trained latents packed (``pallas``) and an image
    prefill (256 patch rows + INTERNVL_TEXT tokens) through
    ``make_prefill``: K1's wrapper launches of the capture, logits and cache
    bitwise equal to the eager prefill's and to the eager prefill with K1
    swapped for its plain version.  Returns the capture's K1 launches."""
    scfg = with_backend(cfg, "pallas")
    served = Z.prepare_serving_params(params, scfg)
    per_forward = SITES_PER_LAYER * cfg.n_layers
    plen = cfg.encoder.n_positions + INTERNVL_TEXT
    prompt = torch.from_numpy(np.random.default_rng(16).integers(0, cfg.vocab_size, size=(1, plen))).to(device)
    frontend = _frontends(scfg, 1, 1, 16, device)[0]

    def eager():
        return Z.prefill(served, prompt, scfg, Z.init_cache(1, INTERNVL_MAX_LEN, scfg, device=device), frontend)

    fn = make_prefill(scfg, 1, plen, INTERNVL_MAX_LEN, device=device)
    cache = Z.init_cache(1, INTERNVL_MAX_LEN, scfg, device=device)
    torch.cuda.synchronize()
    _zero(kernels)
    got, _ = fn(served, prompt, cache, frontend)
    torch.cuda.synchronize()
    launched = _counts(kernels)
    if launched != [2 * per_forward, 0, 0, 0] or fn.captures != 1:
        raise AssertionError(f"[16c] internvl2 make_prefill launches {launched}, {fn.captures} captures; "
                             f"expected K1 = 2 x {per_forward}")
    want, want_cache = eager()
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, plain_cache = eager()
    if not (torch.equal(got, want) and Z.caches_equal(cache, want_cache)):
        raise AssertionError("[16c] internvl2: the compiled prefill differs from the eager one")
    if not (torch.equal(want, plain) and Z.caches_equal(want_cache, plain_cache)):
        raise AssertionError("[16c] internvl2: logits or cache differ with K1 swapped for its plain version")
    if not bool(torch.isfinite(got).all()) or got.shape != (1, cfg.vocab_size):
        raise AssertionError("[16c] internvl2 served logits not finite or of the wrong shape")
    log(f"[16c] {cfg.name} ({cfg.n_layers} layers) trained latents packed (prepare_serving_params, pallas), an "
        f"image prefill ({cfg.encoder.n_positions} patch rows + {INTERNVL_TEXT} tokens) through make_prefill: "
        f"binary_qmm wrapper launches {launched[0]} = 2 x {per_forward} (warm-up run + capture); logits and "
        f"cache bitwise equal to the eager prefill's and with binary_qmm swapped for binary_qmm_ref; argmax "
        f"{int(got.argmax())}")
    del fn, cache, served
    torch.cuda.empty_cache()
    return launched[0]


def _serve_trained_whisper(Z, cfg, params, device, ops, ref, kernels, make_prefill, make_decode_step) -> int:
    """[16c] whisper's trained latents packed (``pallas``) and a batch-4
    transcription over 4 x 1,500 frames: ``make_prefill`` and
    SERVE16_STEPS greedy ``make_decode_step`` calls (K1's wrapper launches
    of the two captures counted), the compiled prefill's logits bitwise the
    eager one's, and an eager prefill + decode step bitwise equal with K1
    swapped for its plain version.  Returns the K1 launches."""
    scfg = with_backend(cfg, "pallas")
    served = Z.prepare_serving_params(params, scfg)
    enc, b, max_len = cfg.encoder, WHISPER_BATCH, WHISPER_MAX_LEN
    per_decode = WHISPER_DECODER_SITES * cfg.n_layers
    per_prefill = per_decode + WHISPER_ENCODER_SITES * enc.n_layers
    prompt = torch.from_numpy(np.random.default_rng(17).integers(0, cfg.vocab_size, size=(b, WHISPER_PROMPT)))
    prompt = prompt.to(device)
    frontend = _frontends(scfg, b, 1, 17, device)[0]

    def eager(n_decode, tokens=None):
        cache = Z.init_cache(b, max_len, scfg, device=device)
        out = [Z.prefill(served, prompt, scfg, cache, frontend)[0]]
        fed = []
        for i in range(n_decode):
            fed.append(out[-1].argmax(-1) if tokens is None else tokens[i])
            out.append(Z.decode_step(served, fed[-1], scfg, cache)[0])
        return out, fed, cache

    pre = make_prefill(scfg, b, WHISPER_PROMPT, max_len, device=device)
    dec = make_decode_step(scfg, b, max_len, device=device)
    cache = Z.init_cache(b, max_len, scfg, device=device)
    torch.cuda.synchronize()
    _zero(kernels)
    first, _ = pre(served, prompt, cache, frontend)
    tokens = [first.argmax(-1)]
    for _ in range(SERVE16_STEPS):
        logits, _ = dec(served, tokens[-1], cache)
        tokens.append(logits.argmax(-1))
    torch.cuda.synchronize()
    launched = _counts(kernels)
    want = [2 * (per_prefill + per_decode), 0, 0, 0]
    if launched != want or (pre.captures, dec.captures, dec.replays) != (1, 1, SERVE16_STEPS - 1):
        raise AssertionError(f"[16c] whisper transcription launches {launched}, expected {want}; "
                             f"{pre.captures} / {dec.captures} captures, {dec.replays} replays")
    kern, fed, eager_cache = eager(1)
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, _, plain_cache = eager(1, tokens=fed)
    if not torch.equal(first, kern[0]):
        raise AssertionError("[16c] whisper: the compiled prefill's logits differ from the eager one's")
    if not all(torch.equal(x, y) for x, y in zip(kern, plain)) or not Z.caches_equal(eager_cache, plain_cache):
        raise AssertionError("[16c] whisper: logits or cache differ with K1 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (b, cfg.vocab_size) for x in kern + [logits]):
        raise AssertionError("[16c] whisper served logits not finite or of the wrong shape")
    log(f"[16c] {cfg.name} trained latents packed (pallas) and a batch-{b} transcription over {b} x "
        f"{enc.n_positions} frames: make_prefill + {SERVE16_STEPS} greedy make_decode_step calls (1 capture + "
        f"{dec.replays} replays), binary_qmm wrapper launches {launched[0]} = 2 x ({per_prefill} + "
        f"{per_decode}); the compiled prefill's logits bitwise the eager one's; an eager prefill + decode "
        f"step bitwise equal with binary_qmm swapped for binary_qmm_ref (logits and cache); row 0's tokens "
        f"{[int(x[0]) for x in tokens]}")
    del pre, dec, cache, served
    torch.cuda.empty_cache()
    return launched[0]


def train_encoders(Z, encoder_cfgs, recurrent_cfg, granite_cfg, device, ops, ref, kernels, smi,
                   make_prefill, make_decode_step, recurrent_f32=None) -> dict:
    """Phase 16.  Returns K1's entries for the trained models served in
    [16c]; the training numbers go on a line of their own (``[16] training
    numbers``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_variant
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    internvl_cfg, whisper_cfg = encoder_cfgs
    t_phase = time.perf_counter()
    numbers, k1 = {}, {}

    # (a) whisper-tiny whole: 4 encoder layers over 8 x 1,500 frames, 4 decoder layers
    _, batch, seq, steps = WHISPER_TRAIN
    wstream = _frontend_stream(whisper_cfg, TokenPipeline, DataConfig)
    wparams, wlosses, wr = _train_run(Z, TL, adamw, whisper_cfg, device, batch, seq, steps, wstream,
                                      f"[16a] {whisper_cfg.name} W1A8 QAT ({whisper_cfg.encoder.n_layers} encoder "
                                      f"layers over {whisper_cfg.encoder.n_positions} frames)", smi, kernels,
                                      phase=16)
    if not wlosses[-1] < wlosses[0]:
        raise AssertionError(f"[16a] whisper loss did not fall: {wlosses}")
    numbers["whisper"] = wr

    # (c) the trained whisper served through K1
    k1["trained_whisper"] = dict(launches=_serve_trained_whisper(Z, whisper_cfg, wparams, device, ops, ref, kernels,
                                                                 make_prefill, make_decode_step))
    del wparams
    torch.cuda.empty_cache()

    # (b) internvl2-2b at full width and depth
    layers, batch, seq, steps = INTERNVL_TRAIN
    icfg = internvl_cfg if layers is None else dataclasses.replace(internvl_cfg, n_layers=layers)
    iparams, ilosses, ir = _train_run(Z, TL, adamw, icfg, device, batch, seq, steps,
                                      _frontend_stream(icfg, TokenPipeline, DataConfig),
                                      f"[16b] {internvl_cfg.name} W1A8 QAT ({icfg.n_layers} of "
                                      f"{internvl_cfg.n_layers} layers, {icfg.encoder.n_positions} patch rows a "
                                      f"row)", smi, kernels, phase=16)
    numbers["internvl2"] = ir
    k1["trained_internvl2"] = dict(launches=_serve_trained_internvl(Z, icfg, iparams, device, ops, ref, kernels,
                                                                    make_prefill))
    del iparams
    torch.cuda.empty_cache()

    # (d) smoke steps on the card against the CPU
    tcfg = TL.TrainConfig()
    for name, variant in TRAIN16_SMOKE:
        scfg = dataclasses.replace(smoke_variant(get_config(name)), **variant)
        if scfg.encoder is not None:
            sbatch = _frontend_stream(scfg, TokenPipeline, DataConfig)(*TRAIN_SMOKE_BATCH, seed=1).next()
        else:
            sbatch = TokenPipeline(DataConfig(vocab_size=scfg.vocab_size, seq_len=TRAIN_SMOKE_BATCH[1],
                                              global_batch=TRAIN_SMOKE_BATCH[0], seed=1)).next()
        loss_gap, gaps, equal, (dev_loss, cpu_loss) = _card_vs_cpu_step(Z, TL, scfg, sbatch, device, tcfg)
        worst = max(gaps, key=gaps.get)
        loss_tol, grad_tol = TRAIN_BOUNDS.get(name, (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL))
        if loss_gap > loss_tol or gaps[worst] > grad_tol:
            raise AssertionError(f"[16d] {scfg.name} {variant} card vs CPU: loss gap {loss_gap:.3g}, gradient gap "
                                 f"{gaps[worst]:.3g} at {worst}")
        log(f"[16d] {scfg.name} {variant or ''} step ({TRAIN_SMOKE_BATCH[0]} x {TRAIN_SMOKE_BATCH[1]}"
            f"{' + a frontend' if scfg.encoder else ''}) on the card against the CPU: loss {dev_loss:.7f} vs "
            f"{cpu_loss:.7f} (relative gap {loss_gap:.3g}); gradient leaves: {equal}/{len(gaps)} bit for bit, "
            f"largest gap {gaps[worst]:.3g} of a leaf's largest magnitude ({worst}; held to {loss_tol} / "
            f"{grad_tol})")
        numbers[f"card_vs_cpu_{name.split('-')[0]}"] = dict(loss_gap=loss_gap, grad_gap=gaps[worst])

    # (e) the bf16 variants at full width, readings beside the float32 runs
    rlayers, rbatch, rseq, _ = RECURRENTGEMMA_TRAIN
    rcfg = dataclasses.replace(recurrent_cfg, n_layers=rlayers, logits_dtype="bf16")

    def stream(batch, seq, seed=0, vocab=rcfg.vocab_size):
        return TokenPipeline(DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed))

    _, _, rr = _train_run(Z, TL, adamw, rcfg, device, rbatch, rseq, BF16_READING_STEPS, stream,
                          f"[16e] {recurrent_cfg.name} ({rlayers} layers) with bf16 logits", smi, kernels, phase=16)
    wcfg = dataclasses.replace(whisper_cfg, attn_scores_dtype="bf16")
    _, _, wbr = _train_run(Z, TL, adamw, wcfg, device, WHISPER_TRAIN[1], WHISPER_TRAIN[2], BF16_READING_STEPS,
                           wstream, f"[16e] {whisper_cfg.name} with bf16 scores", smi, kernels, phase=16)
    for tag, bf, f32 in ((f"{recurrent_cfg.name} bf16 logits", rr, recurrent_f32),
                         (f"{whisper_cfg.name} bf16 scores", wbr, wr)):
        if f32 is None:
            continue
        log(f"[16e] {tag} against float32 (a reading, one card, one run): step p50 {bf['step_p50_ms']:.2f} vs "
            f"{f32['step_p50_ms']:.2f} ms, busy {bf['busy_ms']:.2f} vs {f32['busy_ms']:.2f} ms, peak allocated "
            f"{bf['peak_bytes'] / 1e9:.3f} vs {f32['peak_bytes'] / 1e9:.3f} GB, first loss {bf['first_loss']:.4f} vs "
            f"{f32['first_loss']:.4f} | {smi}")
    numbers["bf16_logits_recurrentgemma"], numbers["bf16_scores_whisper"] = rr, wbr
    torch.cuda.empty_cache()
    log("[16] training numbers: " + json.dumps(numbers))
    log(f"[16] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return k1


# ---------------------------------------------------------------------------
# phase 17: the paper's measurement modules on the card -- the QMM roofline
# and the scores bench on the H100's roofs, the paper's GOPS/W, the examples
# ---------------------------------------------------------------------------

# (M, K, N, act_bits, weight_bits): the main path's sites -- granite-8b W1A8,
# bit-bert-base W1A1, act x act A8xA8 (BERT-base's per-head Q.K^T)
ROOF_SITES = [
    (4, 4096, 14336, 8, 1), (4, 14336, 4096, 8, 1), (4, 4096, 4096, 8, 1), (4, 4096, 1024, 8, 1),
    (128, 4096, 14336, 8, 1),
    (128, 768, 3072, 1, 1), (128, 3072, 768, 1, 1), (128, 768, 768, 1, 1),
    (128, 64, 128, 8, 8),
]
# The backends that launch the kernels, timed as the autotuner times them
# (the fastest of 3 graph replays).  The plain cores are timed on one replay
# and not at granite's 128-row up site, where the `popcount` core takes
# 178 ms a call on an H100, 8.2 s a timing, and checks nothing of a kernel.
KERNEL_BACKENDS = ("pallas", "fused")
PLAIN_UNTIMED = {(128, 4096, 14336, 8, 1)}
# (B, H, G, S, T, dh): bit-bert's prefill, its 4-slot decode, a GQA decode
SCORES_SHAPES = [(1, 12, 12, 128, 128, 64), (4, 12, 12, 1, 512, 64), (4, 32, 8, 1, 512, 128)]
GOPS_W_BITS = (1, 2, 4, 8)  # W1A1 through K3, W1A2 / A4 / A8 through K1
GOPS_W_SECONDS = 5.0  # back-to-back replays a mode
IDLE_SECONDS = 2.0
EXAMPLE_TIMEOUT_S = 300


def _example_runs(device: torch.device, ckpt_dir: str) -> dict:
    dev = ["--device", device.type]
    return {
        "quickstart": ["examples/torch_quickstart.py"] + dev,
        "serve": ["examples/torch_serve_binary_lm.py"] + dev,
        "train": ["examples/torch_train_binary_lm.py", "--steps", "20", "--ckpt-dir", ckpt_dir] + dev,
        "precision_tradeoff": ["examples/torch_precision_tradeoff.py", "--steps", "10"] + dev,
    }


class Nvml:
    """The card's energy counter through NVML (``libnvidia-ml.so.1``, which
    comes with the card's NVIDIA software; ``torch.cuda.power_draw`` would
    need pynvml), the handle matched to the CUDA device by UUID.  Any NVML
    error raises: no number is ever guessed."""

    def __init__(self, device: torch.device):
        import uuid as uuidlib

        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._ok(self.lib.nvmlInit_v2(), "nvmlInit_v2")
        raw = getattr(torch.cuda.get_device_properties(device), "uuid", None)
        if raw is None:
            raise RuntimeError("NVML: torch gives no UUID for the CUDA device to match")
        uuid = f"gpu-{uuidlib.UUID(bytes=bytes(raw.bytes))}"
        count = ctypes.c_uint()
        self._ok(self.lib.nvmlDeviceGetCount_v2(ctypes.byref(count)), "nvmlDeviceGetCount_v2")
        for i in range(count.value):
            h = ctypes.c_void_p()
            self._ok(self.lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h)), "nvmlDeviceGetHandleByIndex_v2")
            buf = ctypes.create_string_buffer(96)
            self._ok(self.lib.nvmlDeviceGetUUID(h, buf, 96), "nvmlDeviceGetUUID")
            if buf.value.decode().lower() == uuid:  # NVML's reads "GPU-<uuid>"
                self.handle, self.match = h, f"UUID {buf.value.decode()}"
                return
        raise RuntimeError(f"NVML: no device has the CUDA device's UUID {uuid}")

    def _ok(self, rc: int, what: str) -> None:
        if rc != 0:
            err = self.lib.nvmlErrorString
            err.restype = ctypes.c_char_p
            raise RuntimeError(f"NVML {what} failed: {err(rc).decode()} ({rc})")

    def energy_j(self) -> float:
        """Joules the card has used since NVML's counter started."""
        mj = ctypes.c_ulonglong()
        self._ok(self.lib.nvmlDeviceGetTotalEnergyConsumption(self.handle, ctypes.byref(mj)),
                 "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1e3


def _plain_kernels(ops, ref):
    """The four QMM kernels swapped for their plain versions."""
    from contextlib import ExitStack

    stack = ExitStack()
    stack.enter_context(mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref))
    stack.enter_context(mock.patch.object(ops._fq, "fused_qmm", ref.fused_qmm_ref))
    stack.enter_context(mock.patch.object(ops._pq, "popcount_qmm",
                                          lambda a, b: ref.popcount_qmm_ref(a, b, 32 * a.shape[1])))
    stack.enter_context(mock.patch.object(ops._bs, "bitserial_qmm",
                                          lambda a, b: ref.bitserial_qmm_ref(a, b, 32 * a.shape[-1])))
    return stack


def roofline_cells(device, ops, ref, kernels) -> dict:
    """[17a] ``measure_cell`` for every registered qmm backend at the main
    path's sites, one draw of the operands a site; each kernel cell's
    product held bitwise to the same call on the kernel's plain version.
    Returns the kernels' launches in the timed calls and the cells."""
    from repro_torch.core import backend_registry
    from repro_torch.core import qmm as QE
    from repro_torch.core import qmm_roofline as R

    names = backend_registry.backend_names(family="qmm")
    cells, launched = [], [0] * len(kernels)
    for site in ROOF_SITES:
        problem = R.make_problem(*site, device=device)  # numpy, ~1.9 s at granite's up site
        _zero(kernels)
        for b in names:
            if b in KERNEL_BACKENDS:
                cells.append(R.measure_cell(b, *site, reps=3, device=device, problem=problem))
            elif site not in PLAIN_UNTIMED:
                cells.append(R.measure_cell(b, *site, reps=1, device=device, problem=problem))
        torch.cuda.synchronize()
        launched = [a + c for a, c in zip(launched, _counts(kernels))]
        xq, wq, colsum = problem
        for backend in KERNEL_BACKENDS:
            got = QE.qmm(xq, wq, backend=backend, w_colsum=colsum)
            with _plain_kernels(ops, ref):
                want = QE.qmm(xq, wq, backend=backend, w_colsum=colsum)
            if not torch.equal(got, want) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"[17a] {backend} (M, K, N, A, W) {site}: kernel != plain version, "
                                     f"max |diff| {(got - want).abs().max().item()}")
        del problem, xq, wq, colsum
    doc = R.validate_qmm_bench(R.make_document(cells, device, names))
    for line in R.format_table(doc).splitlines():
        log(f"[17a] {line}")
    kern = [c["roof_us"] / c["measured_us"] for c in cells if c["backend"] in KERNEL_BACKENDS]
    log(f"[17a] {len(cells)} cells, {len(names)} backends {list(names)} (the plain cores not timed at "
        f"{sorted(PLAIN_UNTIMED)}); the {len(KERNEL_BACKENDS) * len(ROOF_SITES)} kernel cells bitwise equal to "
        f"their plain versions; kernel shares of the roof {min(kern):.4f}-{max(kern):.4f}, none over 1; wrapper "
        f"calls K1 {launched[0]}, K2 {launched[1]}, K3 {launched[2]}, K4 {launched[3]}")
    if not all(launched):
        raise AssertionError(f"[17a] a QMM kernel was never launched: {launched}")
    return dict(launches=launched, cells=cells)


def scores_cells(device, ref, kernel) -> dict:
    """[17b] ``run_attn_bench`` over every scores backend; the kernel's
    scores held bitwise to its plain version at each shape."""
    from repro_torch.core import attn_bench as A

    kernel.launches = 0
    doc = A.run_attn_bench(SCORES_SHAPES, device=device)
    torch.cuda.synchronize()
    launched = kernel.launches
    A.validate_attn_bench(doc)
    for line in A.format_table(doc).splitlines():
        log(f"[17b] {line}")
    for b, h, g, s, t, dh in SCORES_SHAPES:
        q, k = A.make_planes(b, h, s, dh, device=device), A.make_planes(b, g, t, dh, seed=1, device=device)
        got, want = kernel(q, k, dh=dh), ref.binary_attn_scores_ref(q, k, dh)
        if not torch.equal(got, want):
            raise AssertionError(f"[17b] {kernel.__name__} != plain at {(b, h, g, s, t, dh)}")
    if not launched:
        raise AssertionError("[17b] the scores kernel was never launched")
    log(f"[17b] {len(doc['cells'])} cells; {kernel.__name__} bitwise equal to its plain version at "
        f"{len(SCORES_SHAPES)} shapes, {launched} wrapper calls in the bench")
    return dict(launches=launched, cells=doc["cells"])


def gops_per_watt(Z, make_prefill, bert_cfg, device, kernels, smi) -> dict:
    """[17c] The paper's metric on the card: bit-bert-base's 128-token
    prefill through ``make_prefill`` (phase 5's compiled prefill), replayed
    back to back for ``GOPS_W_SECONDS`` at W1A1 (K3) and W1A2 / A4 / A8
    (K1), with the card's energy counter read around the loop.  Operations
    are counted as the paper counts them (``energy_model``: 2 M K N of
    every QMM of one BERT-base forward).  Returns the numbers a mode."""
    from repro_torch.core import energy_model as E
    from repro_torch.core.precision import get_mode

    nvml = Nvml(device)
    ops_fwd = 2 * sum(s.macs for s in E.bert_base_qmm_workload(seq=128))
    per_forward = BERT_SITES_PER_LAYER * bert_cfg.n_layers
    params = Z.init_serving_params(0, with_backend(bert_cfg, "pallas"), device=device)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, bert_cfg.vocab_size, size=(1, 128))).to(device)
    torch.cuda.synchronize()
    e0, t0 = nvml.energy_j(), time.perf_counter()
    time.sleep(IDLE_SECONDS)
    idle_w = (nvml.energy_j() - e0) / (time.perf_counter() - t0)
    log(f"[17c] NVML energy counter matched by {nvml.match}; idle {idle_w:.2f} W over {IDLE_SECONDS:.1f} s "
        f"| {smi}")
    out = {}
    for bits in GOPS_W_BITS:
        # bit-bert-base-a{bits}: the same model at other activation bits
        quant = dataclasses.replace(bert_cfg.quant, act_bits=bits, attn_act_bits=bits, backend="pallas")
        cfg = dataclasses.replace(bert_cfg, quant=quant)
        name = bert_cfg.name if bits == 1 else f"{bert_cfg.name}-a{bits}"
        kernel = kernels[2] if bits == 1 else kernels[0]
        fn = make_prefill(cfg, 1, 128, 512, device=device)
        cache = Z.init_cache(1, 512, cfg, device=device)
        want, _ = Z.prefill(params, tokens, cfg, Z.init_cache(1, 512, cfg, device=device))
        _zero(kernels)
        first, _ = fn(params, tokens, cache)
        torch.cuda.synchronize()
        launched = _counts(kernels)
        expect = [0, 0, 0, 0]
        expect[kernels.index(kernel)] = 2 * per_forward
        if launched != expect or not torch.equal(first, want):
            raise AssertionError(f"[17c] {name}: capture launches {launched} (expected {expect}), logits "
                                 f"{'equal' if torch.equal(first, want) else 'differ from'} the eager prefill")

        def replay():
            for layer in cache["layers"]:
                layer["pos"].zero_()  # the cursor back to 0: every replay the same forward
            return fn(params, tokens, cache)[0]

        replay()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):  # warm replays set the loop's length
            replay()
        torch.cuda.synchronize()
        n = max(1, round(GOPS_W_SECONDS / ((time.perf_counter() - t) / 10)))
        e0, t0 = nvml.energy_j(), time.perf_counter()
        for _ in range(n):
            last = replay()
        torch.cuda.synchronize()
        secs, joules = time.perf_counter() - t0, nvml.energy_j() - e0
        if not torch.equal(last, want):
            raise AssertionError(f"[17c] {name}: the last replay's logits differ from the eager prefill")
        gops = ops_fwd * n / secs / 1e9
        watts = joules / secs
        mode = get_mode(f"W1A{bits}")
        wl, oh = E.bert_base_qmm_workload(), E.BENCHMARK_OVERHEADS["BiT"]
        z_gops, z_eff = E.throughput_gops(wl, mode, E.ZCU102_BETA, oh)[0], E.energy_efficiency(wl, mode, E.ZCU102_BETA, oh)
        out[mode.name] = dict(forwards=n, seconds=secs, ms_per_forward=secs / n * 1e3, gops=gops, watts=watts,
                              idle_watts=idle_w, gops_per_w=gops / watts, joules=joules,
                              launches=launched[kernels.index(kernel)])
        paper = ""
        if bits == 1:
            paper = "; the paper's Table II at W1A1: " + ", ".join(
                f"{k} {v['gops']} GOPS / {v['gops_per_w']} GOPS/W" for k, v in E.PAPER_TABLE2.items())
        log(f"[17c] {name} (W1A{bits}, {kernel.__name__} {launched[kernels.index(kernel)]} wrapper calls in the "
            f"capture): {n} replayed 128-token prefills back to back in {secs:.2f} s ({secs / n * 1e3:.3f} ms each); "
            f"{ops_fwd / 1e9:.2f} G ops a forward -> {gops:.1f} GOPS at {watts:.1f} W mean board power (idle "
            f"{idle_w:.1f} W): {gops / watts:.2f} GOPS/W | BETA on the ZCU102 (energy model, BiT overheads): "
            f"{z_gops:.1f} GOPS, {z_eff:.1f} GOPS/W{paper} | {smi}")
        del fn, cache
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def run_examples(device, workdir: Path) -> dict:
    """[17d] The four torch examples as subprocesses on ``device``, at once;
    each must exit 0.  Returns each one's seconds."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for name, args in _example_runs(device, str(workdir / "train_ckpt")).items():
        out = open(workdir / f"{name}.log", "w+")
        procs[name] = (subprocess.Popen([sys.executable] + args, cwd=ROOT, env=env, stdout=out,
                                        stderr=subprocess.STDOUT), out, time.perf_counter())
    secs, failed = {}, []
    for name, (p, out, t) in procs.items():
        try:
            rc = p.wait(timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t)))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        secs[name] = time.perf_counter() - t
        out.seek(0)
        lines = out.read().splitlines()
        out.close()
        if rc != 0:
            failed.append(name)
            log(f"[17d] {name} exited {rc}; its last lines:\n" + "\n".join(lines[-30:]))
        else:
            log(f"[17d] {name} ({' '.join(_example_runs(device, '...')[name])}) exited 0 in ~{secs[name]:.1f} s: "
                + " | ".join(lines[-3:]))
    for p, _, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
    if failed:
        raise AssertionError(f"[17d] examples failed: {failed}")
    return secs


def measure_modules(Z, bert_cfg, device, ops, ref, kernels, smi, make_prefill) -> dict:
    """Phase 17.  Returns the kernels' entries for the JSON line."""
    t_phase = time.perf_counter()
    qmm_kernels, scores_kernel = kernels[:4], kernels[4]
    roof = roofline_cells(device, ops, ref, qmm_kernels)
    t_roof = time.perf_counter() - t_phase
    scores = scores_cells(device, ref, scores_kernel)
    lap = time.perf_counter()
    t_scores = lap - t_phase - t_roof
    metric = gops_per_watt(Z, make_prefill, bert_cfg, device, qmm_kernels, smi)
    log("[17c] GOPS/W numbers: " + json.dumps(metric))
    t_metric = time.perf_counter() - lap
    with tempfile.TemporaryDirectory(prefix="chip_smoke_17_") as workdir:
        examples = run_examples(device, Path(workdir))
    log(f"[17] phase 17 took {time.perf_counter() - t_phase:.1f} s ([17a] {t_roof:.1f} s, [17b] {t_scores:.1f} s, "
        f"[17c] {t_metric:.1f} s, [17d] {max(examples.values()):.1f} s)")
    names = ("binary_qmm", "fused_qmm", "popcount_qmm", "bitserial_qmm")
    entries = {n: dict(roofline_launches=roof["launches"][i]) for i, n in enumerate(names)}
    entries["binary_attn_scores_planes"] = dict(scores_bench_launches=scores["launches"])
    entries["popcount_qmm"]["gops_per_w"] = metric["W1A1"]
    entries["binary_qmm"]["gops_per_w"] = {k: v for k, v in metric.items() if k != "W1A1"}
    return entries


# ---------------------------------------------------------------------------
# phase 18: multi-device QAT training on torch.distributed -- two ranks on the
# one card (gloo, collectives staged through the host), held to the 1-rank
# step; one rank over NCCL; the trained model served through K3
# ---------------------------------------------------------------------------

MD_BATCH, MD_SEQ, MD_STEPS = 32, 128, 5  # [18a] / [18c]: bit-bert-base, 2 ranks, mesh 2x1
MD_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=MD_STEPS)
MD_GRANITE = (4, 4, 512, 2)  # [18b]: granite-8b layers, batch, seq, steps (prebinarize_gather)
MD_RANKS_TIMEOUT_S = 300
# Stated bounds (ROADMAP section 3).  At W1A1 a trajectory is chaotic:
# Adam's early steps move each latent by about lr whatever its gradient's
# size, so a gradient that differs in its last bits can move an element the
# other way, flip its sign bit and the binarized layer; two runs apart by
# float rounding alone part by 5-53% in loss within 5 steps on an H100
# (PERF.md section 6).  So each 2-rank step is held to the 1-rank step taken
# from the same state, inside the ranks.  Every fake-quant range spans the
# global batch, so the loss differs by the order of the mean alone
# (MD_STEP_LOSS_RTOL).  The gradients are held through the first moments
# AdamW keeps of them: each leaf's largest gap within MD_MU_RTOL of its
# largest value, as the CPU test holds them (each rank's weight gradients
# leave a bf16 product rounded before the ranks' sum).  Fewer than
# MD_APART_SHARE of the params may part by more than lr / 10 (a flipped
# sign moves an element by up to 2 lr).  The params' largest gap is a
# reading only: Adam moves an element by at most about lr a side, so any
# gradient lands within 2 lr.  A gradient of one rank's rows alone (a
# dropped rank) must read beyond MD_MU_RTOL, which shows that the check can
# see it.  [18b] (W1A8) is held to a 1-rank run of its own: its first step
# within MD_STEP_LOSS_RTOL (alpha's partial sums over a K split across the
# ranks are added in another order), its second within MD_LOSS_RTOL.  [18c]
# checks its last step outside the steps: this rank's gradients of its rows
# and their means over the ranks by an all-gather; the int8 average within
# half a quantization step of the mean of the ranks' g + e (MD_HALF_STEP,
# with float32 rounding), the float32 average within MD_F32_RTOL of the
# mean of the ranks' g (of a leaf's largest); and each step's first moments
# within MD_MU_RTOL of AdamW's on those averages (a rank's own gradient,
# unaveraged, must read beyond it).  The loss of the int8 and the float32
# result on the next batch stays within MD_COMPRESSED_LOSS_RTOL: an element
# whose gradient rounds to 0 at int8 gets no Adam step where float32 gives
# it lr, so a fifth of the elements part and the W1A1 loss follows (16% seen
# on an H100, PERF.md section 6).
MD_STEP_LOSS_RTOL = 1e-5
MD_LOSS_RTOL = 2e-2
MD_MU_RTOL = 2.0 ** -6
MD_APART_SHARE = 1e-2
MD_HALF_STEP = 0.5 + 1e-3
MD_F32_RTOL = 2.0 ** -22
MD_COMPRESSED_LOSS_RTOL = 0.25


def _mu_gap(got, want) -> float:
    """The largest, over the leaves, of a leaf's largest gap between two
    trees of the same shapes, of the leaf's largest magnitude in ``want``
    (infinite where ``want``'s leaf is 0 and ``got``'s is not)."""
    worst = 0.0
    for x, y in zip(torch_leaves(got), torch_leaves(want)):
        scale, gap = float(y.abs().max()), float((x - y).abs().max())
        worst = max(worst, gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf")))
    return worst


def _md_rank(rank: int, world: int, tmp: str, plan: dict) -> None:
    """One rank of phase 18: [18a], [18b] and [18c] over a 2x1 mesh (gloo,
    both ranks on the one card), its numbers saved to ``tmp``."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime import collectives as C
    from repro_torch.runtime import fault_tolerance as FT
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import train_loop as TL

    device = torch.device(plan["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=rank, world_size=world)
    out = {}
    try:
        mesh = make_host_mesh(2, 1, device=str(device))
        group = mesh.get_group("data")
        cfg, gcfg = plan["bert"], plan["granite"]
        tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(**MD_OPT))
        lr = MD_OPT["lr"]
        n = 2

        def stream(c, batch, seq):
            return TokenPipeline(DataConfig(vocab_size=c.vocab_size, seq_len=seq, global_batch=batch, seed=0))

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize()

        def start():
            """Zero the peak memory and the collectives' counters: a part begins."""
            sync()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            for counter in (C.STAGED, C.STAGED_S, C.BYTES):
                counter.clear()
            return time.perf_counter()

        def finish(t0):
            """The part's seconds, peak allocated bytes and collectives."""
            sync()
            return dict(s=time.perf_counter() - t0, staged=dict(C.STAGED), staged_s=dict(C.STAGED_S),
                        bytes=dict(C.BYTES),
                        peak=torch.cuda.max_memory_allocated() if device.type == "cuda" else 0)

        def apart(a, b):
            """(largest gap, elements apart by more than lr / 10) of two trees."""
            la, lb = torch_leaves(a), torch_leaves(b)
            return (max(float((x - y).abs().max()) for x, y in zip(la, lb)),
                    sum(int(((x - y).abs() > lr / 10).sum()) for x, y in zip(la, lb)))

        def rows_of(batch):
            """This rank's rows of the global batch, as the steps take them."""
            return {k: torch.as_tensor(v)[rank * MD_BATCH // n:(rank + 1) * MD_BATCH // n].to(device)
                    for k, v in batch.items()}

        # [18a] bit-bert-base whole, FSDP storage, through TrainingRunner;
        # each step beside the 1-rank step from the same state (rank 0)
        t0 = start()
        params, opt = TL.init_train_state(0, cfg, device=device, mesh=mesh)
        p_sh, o_sh = TL.train_shardings(cfg, mesh)
        mesh_step = TL.make_train_step(cfg, tcfg, device=device, mesh=mesh)
        one_step = TL.make_train_step(cfg, tcfg, device=device)
        checks, ms, spent = [], [], Counter()

        def whole(params, opt):
            """The 2-rank state whole on rank 0's card (gathered to rank 0
            alone), None on rank 1."""
            t = time.perf_counter()
            full = SH.gather_tree_to((params, opt), (p_sh, o_sh), device=device)
            sync()
            spent["gather"] += time.perf_counter() - t
            return full

        state = [TL.init_train_state(0, cfg, device=device) if rank == 0 else None]  # the shards' draw

        def checked(params, opt, batch):
            if rank == 0:
                t = time.perf_counter()
                full_p, full_o = state[0]
                want = one_step(full_p, full_o, batch)
                half = None
                if not checks:  # once: one rank's rows alone, as a dropped rank leaves the gradient
                    half = _mu_gap(one_step(full_p, full_o, {k: v[:MD_BATCH // n] for k, v in batch.items()})[1].mu,
                                   want[1].mu)
                del full_p, full_o
                sync()
                spent["one_rank"] += time.perf_counter() - t
            state[0] = None
            sync()
            t = time.perf_counter()
            params, opt, met = mesh_step(params, opt, batch)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            state[0] = whole(params, opt)
            if rank == 0:
                t = time.perf_counter()
                got_p, got_o = state[0]
                gap, n_apart = apart(got_p, want[0])
                loss, ref_loss = float(met["loss"]), float(want[2]["loss"])
                checks.append(dict(loss=loss, ref_loss=ref_loss, loss_gap=abs(loss - ref_loss) / abs(ref_loss),
                                   mu_gap=_mu_gap(got_o.mu, want[1].mu), param_gap=gap, apart=n_apart,
                                   half_mu_gap=half))
                spent["compare"] += time.perf_counter() - t
            return params, opt, met

        runner = FT.TrainingRunner(
            checked, stream(cfg, MD_BATCH, MD_SEQ), CheckpointManager(plan["ckpt"], keep=1, writer=rank == 0),
            FT.RunnerConfig(total_steps=MD_STEPS, checkpoint_every=MD_STEPS, log_every=1),
            log_fn=lambda *_: None, shardings={"params": p_sh, "opt": o_sh})
        t = time.perf_counter()
        params, opt, hist = runner.run(params, opt)
        spent["runner"] = time.perf_counter() - t
        out["a"] = dict(losses=[h["loss"] for h in hist], checks=checks, ms=ms, spent=dict(spent),
                        shard_bytes=sum(x.numel() * x.element_size() for x in torch_leaves((params, opt))),
                        **finish(t0))
        del params, opt, runner, one_step, mesh_step, state

        # [18b] granite-8b at full width, 4 layers, the packed-weight gather
        t0 = start()
        layers, gb, gs, gsteps = MD_GRANITE
        pcfg = dataclasses.replace(gcfg, quant=dataclasses.replace(gcfg.quant, prebinarize_gather=True))
        params, opt = TL.init_train_state(0, pcfg, device=device, mesh=mesh)
        step = TL.make_train_step(pcfg, tcfg, device=device, mesh=mesh)
        pipe = stream(pcfg, gb, gs)
        rows = []
        for _ in range(gsteps):
            TL.GATHERED.update(packed=0, latent=0, latent_equiv=0)
            batch = pipe.next()
            sync()
            t = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            loss = float(met["loss"])
            rows.append(dict(loss=loss, ms=(time.perf_counter() - t) * 1e3, **TL.GATHERED))
        out["b"] = dict(steps=rows, **finish(t0))
        del params, opt, step

        # [18c] the compressed data-parallel step: each step's int8 and
        # float32 updates from the same state, the int8 one carried on;
        # the last step's gradient path checked outside the steps
        t0 = start()
        params, opt = TL.init_train_state(0, cfg, device=device)
        err = compression.init_error_state(params)
        int8 = TL.make_compressed_dp_step(cfg, tcfg, mesh, compress=True, device=device)
        f32 = TL.make_compressed_dp_step(cfg, tcfg, mesh, compress=False, device=device)
        mask = adamw.decay_mask(params, cfg)
        pipe = stream(cfg, MD_BATCH, MD_SEQ)
        rows = []

        def next_loss(p, batch):
            """The loss of params ``p`` on this rank's rows of ``batch``,
            the mean over the ranks (a forward alone)."""
            with torch.no_grad():
                _, m = Z.loss_fn(p, {"tokens": rows_of(batch)["tokens"]}, cfg)
            return float(C.all_reduce(m["loss"], group=group)) / n

        def averages(params, opt, err, batch, mu_i, mu_f):
            """The gradient path of a step, outside it: this rank's
            gradients of its rows, the ranks' means of them by an
            all-gather, ``compressed_psum``'s averages of the same, and the
            first moments AdamW keeps of those against the steps'."""
            _, g = TL.value_and_grad(params, rows_of(batch), cfg, tcfg)
            gl, el = torch_leaves(g), torch_leaves(err)
            sizes = [x.numel() for x in gl]
            g_all = C.all_gather(torch.cat([x.float().reshape(-1) for x in gl]), group)
            c_all = g_all + C.all_gather(torch.cat([x.reshape(-1) for x in el]), group)
            mean_g, mean_c = g_all.sum(0) / n, c_all.sum(0) / n
            avg_i, _ = compression.compressed_psum(g, err, group, True)
            avg_f, _ = compression.compressed_psum(g, err, group, False)
            steps_off = f32_gap = 0.0
            for a_i, a_f, m_g, m_c, c in zip(torch_leaves(avg_i), torch_leaves(avg_f), mean_g.split(sizes),
                                             mean_c.split(sizes), c_all.split(sizes, dim=1)):
                unit = max(float(c.abs().max()), 1e-12) / 127.0
                steps_off = max(steps_off, float((a_i.float().reshape(-1) - m_c).abs().max()) / unit)
                scale = float(m_g.abs().max())
                f32_gap = max(f32_gap, float((a_f.float().reshape(-1) - m_g).abs().max()) / max(scale, 1e-30))
            want_i = adamw.apply_updates(params, avg_i, opt, tcfg.optimizer, mask)[1].mu
            want_f = adamw.apply_updates(params, avg_f, opt, tcfg.optimizer, mask)[1].mu
            own = adamw.apply_updates(params, g, opt, tcfg.optimizer, mask)[1].mu
            return dict(steps_off=steps_off, f32_gap=f32_gap, mu_gap=_mu_gap(mu_i, want_i),
                        mu_gap_f32=_mu_gap(mu_f, want_f), own_mu_gap=_mu_gap(own, want_f))

        batch = pipe.next()
        for i in range(MD_STEPS):
            C.BYTES.clear()
            sync()
            t = time.perf_counter()
            p_i, o_i, err_i, met = int8(params, opt, err, batch)
            sync()
            t_i, bytes_i = (time.perf_counter() - t) * 1e3, sum(C.BYTES.values())
            C.BYTES.clear()
            t = time.perf_counter()
            p_f, o_f, err_f, met_f = f32(params, opt, err, batch)
            sync()
            t_f, bytes_f = (time.perf_counter() - t) * 1e3, sum(C.BYTES.values())
            check = averages(params, opt, err, batch, o_i.mu, o_f.mu) if i == MD_STEPS - 1 else {}
            gap, n_apart = apart(p_i, p_f)
            batch = pipe.next()
            rows.append(dict(loss=float(met["loss"]), loss_f32=float(met_f["loss"]), param_gap=gap,
                             apart=n_apart, next_loss=next_loss(p_i, batch), next_loss_f32=next_loss(p_f, batch),
                             ms=t_i, ms_f32=t_f, bytes=bytes_i, bytes_f32=bytes_f,
                             err_kept=all(x is y for x, y in zip(torch_leaves(err_f), torch_leaves(err))), **check))
            params, opt, err = p_i, o_i, err_i
            del p_f, o_f
        out["c"] = dict(steps=rows, payload=compression.payload_bytes(params), n_leaves=len(torch_leaves(params)),
                        n=sum(x.numel() for x in torch_leaves(params)), **finish(t0))
        del params, opt, err
    finally:
        torch.save(out, f"{tmp}/rank{rank}.pt")
        dist.destroy_process_group()


def torch_leaves(tree):
    from repro_torch.core.tree import leaves

    return leaves(tree)


def train_multidevice(Z, bert_cfg, granite_cfg, device, ops, ref, kernels, smi, workdir: Path) -> dict:
    """Phase 18.  Returns K3's ``multidevice`` entry (its launches in
    [18e]'s ``Z.prefill`` of the 2-rank-trained model) and the phase's
    numbers, with [18b]'s granite-8b ``layers``."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    t_phase = time.perf_counter()
    cfg = bert_cfg
    layers, gb, gs, gsteps = MD_GRANITE
    gcfg = dataclasses.replace(granite_cfg, n_layers=layers)
    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(**MD_OPT))
    lr = MD_OPT["lr"]
    tmp = workdir / "ranks"
    tmp.mkdir()
    plan = dict(device=str(device), bert=cfg, granite=gcfg, ckpt=str(workdir / "ckpt_a"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_md_rank, args=(r, 2, str(tmp), plan)) for r in range(2)]
    for p in procs:
        p.start()

    def stream(c, batch, seq):
        return TokenPipeline(DataConfig(vocab_size=c.vocab_size, seq_len=seq, global_batch=batch, seed=0))

    # while the ranks run: [18b]'s reference, a 1-rank prebinarized run
    pcfg = dataclasses.replace(gcfg, quant=dataclasses.replace(gcfg.quant, prebinarize_gather=True))
    gp, go = TL.init_train_state(0, pcfg, device=device)
    gp, go, ref_glosses, _ = _timed_steps(TL.make_train_step(pcfg, tcfg, device=device), gp, go,
                                          stream(pcfg, gb, gs), gsteps)
    del gp, go
    torch.cuda.empty_cache()

    # [18d] one rank over NCCL: the mesh step against the step without a group
    p0, o0 = TL.init_train_state(0, cfg, device=device)
    batch0 = stream(cfg, MD_BATCH, MD_SEQ).next()
    plain = TL.make_train_step(cfg, tcfg, device=device)(p0, o0, batch0)
    dist.init_process_group("nccl", init_method=f"file://{workdir}/nccl_init", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=str(device))
        ps, os_ = TL.init_train_state(0, cfg, device=device, mesh=mesh)
        meshed = TL.make_train_step(cfg, tcfg, device=device, mesh=mesh)(ps, os_, batch0)
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if not (_trees_equal(meshed[0], plain[0]) and _trees_equal(meshed[1], plain[1])
            and all(torch.equal(meshed[2][k], plain[2][k]) for k in plain[2])):
        raise AssertionError("[18d] the 1-rank NCCL mesh step differs from the step without a process group")
    log(f"[18d] one rank over {backend} (mesh 1x1, {cfg.name}, {MD_BATCH} x {MD_SEQ}): the mesh step's params, "
        f"AdamW state and metrics bit for bit the step without a process group's (each collective over a "
        f"group of one rank is the identity: the gradients' reduce-scatter, the fake-quant range, loss and "
        f"global-norm all-reduces; the gathers skip an axis of one rank) | {smi}")
    del p0, o0, ps, os_, plain, meshed
    torch.cuda.empty_cache()
    t_parent = time.perf_counter() - t_phase

    for p in procs:
        p.join(max(1.0, MD_RANKS_TIMEOUT_S - (time.perf_counter() - t_phase)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"[18] ranks exited {[p.exitcode for p in procs]}")
    t_ranks = time.perf_counter() - t_phase
    runs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    a = runs[0]["a"]
    n_el = sum(x.numel() for x in torch_leaves(Z.init_params(0, cfg, device="meta")))

    def staged(part):
        return ", ".join(f"{op} {part['staged'][op]} calls {part['staged_s'].get(op, 0.0):.2f} s"
                         for op in sorted(part["staged"]))

    # [18a] each 2-rank step against the 1-rank step from the same state
    checks = a["checks"]
    half = checks[0]["half_mu_gap"] if checks else None
    bad = [c for c in checks if c["loss_gap"] > MD_STEP_LOSS_RTOL or c["mu_gap"] > MD_MU_RTOL
           or c["apart"] > MD_APART_SHARE * n_el]
    if len(checks) != MD_STEPS or bad or runs[1]["a"]["losses"] != a["losses"] or not half > MD_MU_RTOL:
        raise AssertionError(f"[18a] 2-rank steps against the 1-rank step from the same state: {checks}")
    log(f"[18a] {cfg.name} whole ({cfg.n_layers} layers, d_model {cfg.d_model}) in 2 ranks on the one card "
        f"(gloo, mesh 2x1, FSDP storage: {a['shard_bytes'] / 1e6:.1f} MB of latents and moments a rank), "
        f"{MD_STEPS} steps of {MD_BATCH} x {MD_SEQ} through TrainingRunner, the checkpoint gathered to rank 0 "
        f"alone; each step against the 1-rank step from the same state (gathered to rank 0): loss relative gaps "
        + ", ".join(f"{c['loss_gap']:.3g}" for c in checks) + f" (held to {MD_STEP_LOSS_RTOL}); first moments' "
        "largest gap of a leaf's largest " + ", ".join(f"{c['mu_gap']:.3g}" for c in checks)
        + f" (held to {MD_MU_RTOL:g}; the gradient of one rank's rows alone reads {half:.3g}, held to exceed "
        f"it); elements apart by more than lr / 10: " + ", ".join(str(c["apart"]) for c in checks)
        + f" of {n_el} (held under {MD_APART_SHARE:g} of them); params largest gaps (a reading, 2 lr = "
        f"{2 * lr:g} holds any update) " + ", ".join(f"{c['param_gap']:.3g}" for c in checks) + "; losses "
        + " ".join(f"{x:.6f}" for x in a["losses"]) + "; mesh step ms " + ", ".join(f"{x:.0f}" for x in a["ms"])
        + f"; [18a] took {a['s']:.1f} s in the ranks (rank 0: the runner {a['spent']['runner']:.1f} s, of "
        f"it the mesh steps {sum(a['ms']) / 1e3:.1f} s, the check's gathers of the state "
        f"{a['spent']['gather']:.1f} s, its 1-rank steps {a['spent']['one_rank']:.1f} s, its comparisons "
        f"{a['spent']['compare']:.1f} s); peak allocated rank 0 {a['peak'] / 1e9:.3f} GB (with the "
        f"1-rank check), rank 1 {runs[1]['a']['peak'] / 1e9:.3f} GB; host-staged gloo ops (rank 0) {staged(a)} "
        f"| {smi}")

    # [18b] granite-8b with the packed-weight gather
    b = runs[0]["b"]["steps"]
    ggaps = [abs(r["loss"] - y) / abs(y) for r, y in zip(b, ref_glosses)]
    if ggaps[0] > MD_STEP_LOSS_RTOL or max(ggaps) > MD_LOSS_RTOL or not all(np.isfinite(r["loss"]) for r in b) \
            or [r["loss"] for r in runs[1]["b"]["steps"]] != [r["loss"] for r in b]:
        raise AssertionError(f"[18b] prebinarized 2 ranks vs 1: loss gaps {ggaps}")
    g0 = b[0]
    log(f"[18b] {gcfg.name} at full width, {layers} of its {granite_cfg.n_layers} layers, prebinarize_gather "
        f"on, mesh 2x1, {gsteps} steps of {gb} x {gs}: losses " + " ".join(f"{r['loss']:.6f}" for r in b)
        + " against the 1-rank prebinarized run's " + " ".join(f"{x:.6f}" for x in ref_glosses)
        + f" (relative gaps {', '.join(f'{x:.3g}' for x in ggaps)}; held to {MD_STEP_LOSS_RTOL} / "
        f"{MD_LOSS_RTOL}); gathered into a rank a step: QMM weights {g0['packed'] / 1e6:.2f} MB as packed sign "
        f"words against {g0['latent_equiv'] / 1e6:.1f} MB as the float32 latents they replace "
        f"({g0['latent_equiv'] / max(g0['packed'], 1):.1f}x), other leaves {g0['latent'] / 1e6:.1f} MB float32; "
        f"step ms " + ", ".join(f"{r['ms']:.0f}" for r in b) + f"; [18b] took {runs[0]['b']['s']:.1f} s in the "
        f"ranks; peak allocated {runs[0]['b']['peak'] / 1e9:.2f} / {runs[1]['b']['peak'] / 1e9:.2f} GB; "
        f"host-staged gloo ops (rank 0) {staged(runs[0]['b'])} | {smi}")

    # [18c] the compressed data-parallel step
    c = runs[0]["c"]
    rows = c["steps"]
    fin = rows[-1]
    cgaps = [abs(r["next_loss"] - r["next_loss_f32"]) / abs(r["next_loss_f32"]) for r in rows]
    bad = [r for r in rows if r["loss"] != r["loss_f32"] or not r["err_kept"]]
    if bad or max(cgaps) > MD_COMPRESSED_LOSS_RTOL or fin["steps_off"] > MD_HALF_STEP \
            or fin["f32_gap"] > MD_F32_RTOL or max(fin["mu_gap"], fin["mu_gap_f32"]) > MD_MU_RTOL \
            or not fin["own_mu_gap"] > MD_MU_RTOL \
            or [r["loss"] for r in runs[1]["c"]["steps"]] != [r["loss"] for r in rows]:
        raise AssertionError(f"[18c] compressed vs float32 DP: {rows}")
    i8, f32 = c["payload"]
    log(f"[18c] make_compressed_dp_step on {cfg.name} in 2 ranks (params replicated, each rank's ranges "
        f"local), {MD_STEPS} steps of {MD_BATCH} x {MD_SEQ}, the int8 error-feedback update and the float32 "
        f"one from the same state at each step; step {MD_STEPS} checked outside the steps against the ranks' "
        f"gradients all-gathered: the int8 average within {fin['steps_off']:.4f} of a quantization step of "
        f"the mean of the ranks' g + e (held to {MD_HALF_STEP}), the float32 average within "
        f"{fin['f32_gap']:.3g} of the mean of their g (of a leaf's largest; held to {MD_F32_RTOL:.3g}); the "
        f"steps' first moments against AdamW's on those averages: int8 {fin['mu_gap']:.3g}, float32 "
        f"{fin['mu_gap_f32']:.3g} (held to {MD_MU_RTOL:g}; a rank's own gradient unaveraged reads "
        f"{fin['own_mu_gap']:.3g}, held to exceed it); losses " + " ".join(f"{r['loss']:.6f}" for r in rows)
        + "; the two results' loss on the next batch "
        + ", ".join(f"{r['next_loss']:.6f} / {r['next_loss_f32']:.6f}" for r in rows)
        + " (relative gaps " + ", ".join(f"{x:.3g}" for x in cgaps) + f"; held to {MD_COMPRESSED_LOSS_RTOL}); "
        "params largest gaps (a reading) " + ", ".join(f"{r['param_gap']:.3g}" for r in rows)
        + ", elements apart by more than lr / 10: " + ", ".join(str(r["apart"]) for r in rows)
        + f" of {c['n']}; bytes a rank handed to the collectives a step: int8 {rows[0]['bytes'] / 1e6:.1f} MB "
        f"(the mantissas' int32 sum, the MAX of {c['n_leaves']} leaves' maxima, the metrics), float32 "
        f"{rows[0]['bytes_f32'] / 1e6:.1f} MB (the int8 payload's own size {i8 / 1e6:.1f} MB, float32's "
        f"{f32 / 1e6:.1f} MB); step ms int8 " + ", ".join(f"{r['ms']:.0f}" for r in rows) + ", float32 "
        + ", ".join(f"{r['ms_f32']:.0f}" for r in rows) + f"; [18c] took {c['s']:.1f} s in the ranks; peak "
        f"allocated {c['peak'] / 1e9:.2f} GB; host-staged gloo ops (rank 0) {staged(c)} | {smi}")

    # [18e] the 2-rank-trained model (rank 0's checkpoint) served through K3 (W1A1)
    like = TL.init_train_state(0, cfg, device=device)
    step_no, saved, _ = CheckpointManager(plan["ckpt"]).restore(like={"params": like[0], "opt": like[1]})
    del like
    if step_no != MD_STEPS:
        raise AssertionError(f"[18e] the ranks' checkpoint is of step {step_no}")
    serve_cfg = with_backend(cfg, "pallas")
    sp = Z.prepare_serving_params(saved["params"], serve_cfg)
    prompt = torch.as_tensor(stream(cfg, 1, MD_SEQ).next()["tokens"], device=device).to(torch.int64)
    per_forward = BERT_SITES_PER_LAYER * cfg.n_layers

    def serve_prefill():
        return Z.prefill(sp, prompt, serve_cfg, Z.init_cache(1, MD_SEQ, serve_cfg, device=device))

    torch.cuda.synchronize()
    _zero(kernels)
    last, cache = serve_prefill()
    torch.cuda.synchronize()
    launched = _counts(kernels)
    if launched != [0, 0, per_forward, 0]:
        raise AssertionError(f"[18e] the trained model's prefill launched K1-K4 {launched}; expected K3 = "
                             f"{per_forward} and no other")
    plain_k3 = lambda x, w: ref.popcount_qmm_ref(x, w, 32 * x.shape[1])  # noqa: E731
    with mock.patch.object(ops._pq, "popcount_qmm", plain_k3):
        last_plain, cache_plain = serve_prefill()
    if not torch.equal(last, last_plain) or not Z.caches_equal(cache, cache_plain):
        raise AssertionError("[18e] the 2-rank-trained model's prefill differs with K3 swapped for its plain "
                             "version")
    if not bool(torch.isfinite(last).all()) or last.shape != (1, cfg.vocab_size):
        raise AssertionError("[18e] served logits not finite or of the wrong shape")
    log(f"[18e] the 2-rank-trained params (rank 0's checkpoint) packed and a {MD_SEQ}-token Z.prefill served at "
        f"W1A1: popcount_qmm launches {launched[2]} = {BERT_SITES_PER_LAYER} x {cfg.n_layers}, logits and cache "
        f"bitwise equal with popcount_qmm swapped for popcount_qmm_ref | {smi}")
    numbers = dict(a_step_loss_gaps=[x["loss_gap"] for x in checks], a_mu_gaps=[x["mu_gap"] for x in checks],
                   a_half_batch_mu_gap=half, a_apart=[x["apart"] for x in checks],
                   a_param_gaps=[x["param_gap"] for x in checks], a_step_ms=a["ms"], a_spent=a["spent"],
                   a_peak_bytes=[r["a"]["peak"] for r in runs], b_loss_gaps=ggaps, b_step_ms=[r["ms"] for r in b],
                   b_packed_bytes=g0["packed"], b_latent_equiv_bytes=g0["latent_equiv"], b_float_bytes=g0["latent"],
                   c_next_loss_gaps=cgaps, c_steps_off=fin["steps_off"], c_f32_gap=fin["f32_gap"],
                   c_mu_gaps=[fin["mu_gap"], fin["mu_gap_f32"]], c_own_mu_gap=fin["own_mu_gap"],
                   c_step_ms=[r["ms"] for r in rows], c_step_ms_f32=[r["ms_f32"] for r in rows],
                   c_bytes=[rows[0]["bytes"], rows[0]["bytes_f32"]], c_payload_int8=i8, c_payload_float32=f32,
                   seconds={"a": a["s"], "b": runs[0]["b"]["s"], "c": c["s"], "parent": t_parent,
                            "ranks": t_ranks},
                   staged={k: {"calls": runs[0][k]["staged"], "s": runs[0][k]["staged_s"],
                               "bytes": runs[0][k]["bytes"]} for k in "abc"})
    log("[18] multi-device numbers (rank 0's parts; staged: its host-staged gloo collectives by op): "
        + json.dumps(numbers) + f" | {smi}")
    del saved, sp
    torch.cuda.empty_cache()
    log(f"[18] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launched[2]), dict(numbers, layers=layers)


# ---------------------------------------------------------------------------
# phase 19: the static-analysis and dry-run modules on the card -- the
# invariant verifier over the real launches (the five kernel wrappers as its
# trusted boundaries), the self-test, and the dry-run's accounts held to
# what the card allocates and what phase [18b]'s gathers moved
# ---------------------------------------------------------------------------

VERIFY_SHAPES = [(8, 64, 16), (4, 4096, 14336)]  # [19a]: the verifier's own (M, K, N), granite's up site
VERIFY_PROMPT = 128  # [19b]: one 128-token prefill, then one decode step
VERIFY_MAX_LEN = 256
ALLOC_ROUND = 512  # the caching allocator rounds every block up to 512 bytes


def _qlinear_records(records) -> int:
    return sum(1 for r in records if r["kind"] == "qlinear" and r["site"])


def verify_and_dry_run(Z, granite_cfg, bert_cfg, device, kernels, smi, md_numbers: dict) -> dict:
    """Phase 19.  Returns each kernel wrapper's ``verified`` count: the
    boundaries [19a] and [19b] crossed, each equal to its launches there."""
    from repro_torch.analysis import selftest, verifier
    from repro_torch.analysis.findings import render_text
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.runtime import train_loop as TL

    t_phase = time.perf_counter()
    names = [k.__name__ for k in kernels]
    verified = Counter()

    def walked(tag: str, run) -> dict:
        """``run()``'s findings (required: none) and the kernel boundaries
        it crossed, each required equal to its wrapper's launches."""
        torch.cuda.synchronize()
        _zero(kernels)
        verifier.CROSSED.clear()
        t = time.perf_counter()
        found = run()
        torch.cuda.synchronize()
        launched = dict(zip(names, _counts(kernels)))
        crossed = {n: verifier.CROSSED.get(n, 0) for n in names}
        if found:
            raise AssertionError(f"[19] {tag}: {len(found)} finding(s)\n" + render_text(found))
        if crossed != launched:
            raise AssertionError(f"[19] {tag}: kernel boundaries crossed {crossed}, launches {launched}")
        verified.update(crossed)
        log(f"[19] {tag}: 0 findings; boundaries crossed = launches "
            + ", ".join(f"{n} {c}" for n, c in crossed.items() if c) + f" ({time.perf_counter() - t:.1f} s)")
        return crossed

    # [19a] every QMM backend of the registry, W1A8 / W1A1 / A8xA8, on the card
    for m, k, n in VERIFY_SHAPES:
        crossed = walked(f"[19a] verify_backends at ({m}, {k}, {n})",
                         lambda: verifier.verify_backends(device=device, shape=(m, k, n)))
        if [crossed[x] for x in names[:4]] != [1, 3, 1, 1]:
            raise AssertionError(f"[19a] expected K1 1 (pallas W1A8), K2 3 (fused), K3 1, K4 1: {crossed}")

    # [19b] granite-8b at full width and depth on pallas and fused; bit-bert-base W1A1 with
    # attn.qk -> binary; each a 128-token prefill and one decode step
    per_forward = SITES_PER_LAYER * granite_cfg.n_layers
    params = Z.init_serving_params(0, with_backend(granite_cfg, "pallas"), device=device)
    for backend, kernel in (("pallas", names[0]), ("fused", names[1])):
        cfg = with_backend(granite_cfg, backend)
        crossed = walked(f"[19b] verify_arch {cfg.name} ({cfg.n_layers} layers) on {backend}",
                         lambda: verifier.verify_arch(cfg.name, device=device, cfg=cfg, params=params, batch=1,
                                                      max_len=VERIFY_MAX_LEN, prompt_len=VERIFY_PROMPT))
        named = [_qlinear_records(verifier.RECORDS[f"arch:{cfg.name}:{step}"]) for step in ("prefill", "decode")]
        if named != [per_forward] * 2 or crossed[kernel] != 2 * per_forward:
            raise AssertionError(f"[19b] {backend}: named qlinear records {named}, {kernel} crossed "
                                 f"{crossed[kernel]}; expected {per_forward} a forward")
    log(f"[19b] {granite_cfg.name}: {per_forward} named qlinear site records a forward on each backend, the "
        f"cache contract held through the prefill and the decode step | {smi}")
    del params
    torch.cuda.empty_cache()
    bcfg = _with_qk(with_backend(bert_cfg, "pallas"), "binary")
    bparams = Z.init_serving_params(0, bcfg, device=device)
    bert_forward = BERT_SITES_PER_LAYER * bcfg.n_layers
    with mock.patch.dict(os.environ, {"REPRO_QMM_AUTOTUNE": "0"}):  # the scores core is the kernel
        crossed = walked(f"[19b] verify_binary_attention {bcfg.name} W1A1, attn.qk -> binary",
                         lambda: verifier.verify_binary_attention(device=device, cfg=bcfg, params=bparams, batch=1,
                                                                  max_len=VERIFY_MAX_LEN,
                                                                  prompt_len=VERIFY_PROMPT))
    named = [_qlinear_records(verifier.RECORDS[f"binary-attn:{step}"]) for step in ("prefill", "decode")]
    if (named != [bert_forward] * 2 or crossed[names[2]] != 2 * bert_forward
            or crossed[names[4]] != 1 + 2 * bcfg.n_layers):
        raise AssertionError(f"[19b] {bcfg.name}: named records {named}, crossed {crossed}; expected "
                             f"K3 {bert_forward} and the scores kernel {bcfg.n_layers} a forward (+1, the core sweep)")
    log(f"[19b] {bcfg.name}: K3 {bert_forward} and the scores kernel {bcfg.n_layers} a forward, "
        f"{bert_forward} named qlinear records a forward | {smi}")
    del bparams
    torch.cuda.empty_cache()

    # [19c] the self-test with CUDA tensors: every seeded fixture flagged
    t = time.perf_counter()
    failures = selftest.run(str(ROOT), device=device)
    if failures:
        raise AssertionError("[19c] self-test: " + "; ".join(failures))
    log(f"[19c] self-test on the card: every seeded lint rule and trace invariant flagged, the fused and "
        f"scores cores clean ({time.perf_counter() - t:.1f} s)")

    # [19d] the dry-run's cells, then its accounts against the card
    t = time.perf_counter()
    cells = {(arch, shape, mesh): dryrun.run_cell(arch, shape, mesh)
             for arch, shape, mesh in (("granite-8b", "train_4k", "single"), ("granite-8b", "train_4k", "multi"),
                                       ("smoke", "smoke", "single"))}
    for key, rec in cells.items():
        rec.pop("traceback", None)
        log(f"[19d] dry-run {' '.join(key)}: " + json.dumps(rec))
    single, multi, smoke = cells.values()
    if (single["status"] != "ok" or not single["flops"] > 0 or "'pod' axis" not in multi.get("error", "")
            or smoke["memory"]["argument_size_in_bytes"] != 3524):
        raise AssertionError(f"[19d] dry-run cells: {[(r['status'], r.get('error')) for r in cells.values()]}")
    layers = md_numbers["layers"]
    gcfg = dataclasses.replace(granite_cfg, n_layers=layers)
    args = dryrun.argument_bytes(gcfg, SHAPES_BY_NAME["train_4k"], abstract_mesh((1, 1), ("data", "model")))
    predicted = args["params"] + args["opt_state"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    state = TL.init_train_state(0, gcfg, device=device)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    n_tensors = len(torch_leaves(state))
    rounded = sum(-(-x.numel() * x.element_size() // ALLOC_ROUND) * ALLOC_ROUND for x in torch_leaves(state))
    del state
    torch.cuda.empty_cache()
    if not 0 <= grown - predicted <= ALLOC_ROUND * n_tensors:
        raise AssertionError(f"[19d] predicted {predicted} B of params and AdamW state, the card allocated {grown} B "
                             f"for {n_tensors} tensors")
    pcfg = dataclasses.replace(gcfg, quant=dataclasses.replace(gcfg.quant, prebinarize_gather=True))
    plan = dryrun.collective_bytes(pcfg, abstract_mesh((2, 1), ("data", "model")))
    seen = {"packed": md_numbers["b_packed_bytes"], "latent": md_numbers["b_float_bytes"],
            "latent_equiv": md_numbers["b_latent_equiv_bytes"]}
    if plan["gathered"] != seen:
        raise AssertionError(f"[19d] the dry-run's 2x1 gathers {plan['gathered']} != [18b]'s counters {seen}")
    log(f"[19d] {gcfg.name} on {layers} of {granite_cfg.n_layers} layers, mesh 1x1: the dry-run predicts "
        f"{predicted} B of params ({args['params']}) and AdamW state ({args['opt_state']}); building them on "
        f"the card grew torch.cuda.memory_allocated by {grown} B ({grown - predicted} B over, {n_tensors} tensors "
        f"each rounded up to {ALLOC_ROUND} B: {rounded} B); mesh 2x1 with the packed gather: the dry-run's plan "
        f"gathers {plan['gathered']['packed']} B of sign words, {plan['gathered']['latent']} B of float leaves "
        f"({plan['gathered']['latent_equiv']} B as float32 latents) into a rank a step, equal to [18b]'s counters; "
        f"its all-gathers {plan['all-gather']} and reduce-scatter {plan['reduce-scatter']} a step "
        f"({time.perf_counter() - t:.1f} s) | {smi}")
    log(f"[19] phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return {n: verified[n] for n in names}


# The serving paths of phases 7-9 at full width, cut in depth so that the
# whole run stays well inside its 1,200 s on a slow host (1,157.2 s with
# every path at full depth on an H100): gemma3-27b its prefix and one period
# (8 of 62 layers: 7 local ring layers, 1 global), deepseek-v2-lite-16b its
# "Md" layer and 3 of 26 "Mm", recurrentgemma-2b its prefix and two periods
# (8 of 26: 6 RG-LRU, 2 local).  Every kind of layer and every cache form
# stays; phase 15 trains each at its own depth.
SERVE_LAYERS = {"gemma3-27b": 8, "deepseek-v2-lite-16b": 4, "recurrentgemma-2b": 8}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config

    def cut(name):
        cfg = get_config(name)
        return dataclasses.replace(cfg, n_layers=SERVE_LAYERS[name]) if name in SERVE_LAYERS else cfg

    return run(torch.device("cuda", 0), get_config("granite-8b"), get_config("bit-bert-base"),
               cut("gemma3-27b"), cut("deepseek-v2-lite-16b"),
               (cut("recurrentgemma-2b"), get_config("mamba2-130m")),
               (get_config("internvl2-2b"), get_config("whisper-tiny")))


def run(device: torch.device, model_cfg, bert_cfg, gemma3_cfg, deepseek_cfg, recurrent_cfgs,
        encoder_cfgs) -> int:
    from repro_torch.kernels import binary_attn as K5
    from repro_torch.kernels import binary_qmm as K1
    from repro_torch.kernels import bitserial_qmm as K4
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fused_qmm as K2
    from repro_torch.kernels import ops
    from repro_torch.kernels import popcount_qmm as K3
    from repro_torch.models import model_zoo as Z
    from repro_torch.runtime.serve_loop import (
        Request,
        ServeEngine,
        make_decode_step,
        make_prefill,
        serve_sequential,
    )

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[1] card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t = time.perf_counter()
    rate_job = start_mma_rate_build(build)
    libs = build.build_all()
    log(f"[1] built {sorted(libs)} in {time.perf_counter() - t:.1f} s (parallel nvcc, sm_90a)")
    for name, (secs, report) in sorted(build.BUILD_LOG.items()):
        usage = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[1]   {name}: {secs:.1f} s; " + " | ".join(usage))

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    laps = [time.perf_counter()]

    def lap(phase: str) -> None:
        laps.append(time.perf_counter())
        log(f"[{phase}] phase {phase} took {laps[-1] - laps[-2]:.1f} s")

    rates = mma_rates(rate_job)
    log("[2] mma.sync from registers, every SM: " + ", ".join(
        f"{name} {r / 1e12:.1f} TOP/s" for name, r in rates.items()))
    log("[2] kernels against their plain versions (M, K, N):")
    rows = check_kernels(gen)
    rows.update(check_bit_kernels(gen))
    lap("2")

    # ---- phase 3: main path, full width and depth
    cfg = with_backend(model_cfg, "pallas")
    per_forward = SITES_PER_LAYER * cfg.n_layers
    t = time.perf_counter()
    params = Z.init_serving_params(0, cfg, device=device)
    torch.cuda.synchronize()
    log(f"[3] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; serving params built on the card in "
        f"{time.perf_counter() - t:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    # warm-up (allocator, cuBLAS handles) on its own engine: a fresh engine
    # numbers requests from 0, as serve_sequential does, so sampled requests
    # draw from the same default_rng([seed, rid]) streams
    ServeEngine(cfg, params, batch_slots=4, max_len=512, seed=0, device=device).run(
        make_requests(Request, n=2, seed=1, vocab=cfg.vocab_size))
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=512, seed=0, device=device)
    torch.cuda.synchronize()
    reqs = make_requests(Request, vocab=cfg.vocab_size)
    all_kernels = (K1.binary_qmm, K2.fused_qmm, K3.popcount_qmm, K4.bitserial_qmm)
    _zero(all_kernels)
    t = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = _counts(all_kernels)
    if not all(r.state == "ok" and len(r.output) == 16 for r in done):
        raise AssertionError(f"requests not ok: {[(r.state, len(r.output)) for r in done]}")
    prefill_ms = [e["ms"] for e in engine.last_events if e["kind"] == "prefill"]
    n_tok = sum(len(r.output) for r in done)
    plens = [len(r.prompt) for r in done]
    log(f"[3] served {len(done)} requests (prompts {min(plens)}-{max(plens)} tokens, 16 new each, "
        f"6 greedy + 2 at T=0.8) in {wall:.2f} s: {n_tok / wall:.1f} generated tokens/s end to end; "
        f"eager exact-length prefills {sum(prefill_ms) / 1e3:.2f} s of it")
    engine_counts(engine, all_kernels, launched, per_forward, K1.binary_qmm, phase=3)
    k1 = dict(launches=launched[0], replays=engine.decode_fn.replays)
    log(f"[3] prefill ms: mean {np.mean(prefill_ms):.1f} (per prompt: "
        + ", ".join(f"{p}:{ms:.1f}" for p, ms in zip(plens, prefill_ms)) + ")")
    del engine

    seq = serve_sequential(cfg, params, make_requests(Request, vocab=cfg.vocab_size), max_len=512, seed=0, device=device)
    for got, want in zip(done, seq):
        if got.temperature == 0 and got.output != want.output:
            raise AssertionError(f"engine greedy tokens {got.output} != sequential {want.output}")
    sampled_same = sum(g.output == w.output for g, w in zip(done, seq) if g.temperature > 0)
    log(f"[3] engine greedy tokens equal serve_sequential for all 6 greedy requests "
        f"(sampled requests equal: {sampled_same}/2)")

    # where the time goes: the 4-slot tick eager and replayed, and one
    # (eager, exact-length) prefill, profiled
    cache = fill_cache(Z, cfg, params, [r.prompt for r in done[:4]], device)
    step = torch.tensor([r.output[0] for r in done[:4]], device=device)
    k1.update(graph_vs_eager(Z, make_decode_step, cfg, params, cache, 512, step, K1.binary_qmm,
                             per_forward, phase=3, tag="pallas decode tick (4 slots)"))
    long = max(done, key=lambda r: len(r.prompt))
    tokens = torch.as_tensor(np.asarray(long.prompt)[None], device=device)
    report_profile(f"eager prefill ({len(long.prompt)} tokens)", *profile_forward(
        lambda: Z.prefill(params, tokens, cfg, Z.init_slot_cache(512, cfg, device=device))))

    prompt = np.asarray(done[0].prompt)
    kern, fed = greedy_steps(Z, cfg, params, prompt, 1, device)
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, _ = greedy_steps(Z, cfg, params, prompt, 1, device, tokens=fed)
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError("pallas-path logits differ with K1 swapped for its plain version")
    log(f"[3] prefill ({len(prompt)} tokens) + decode logits bitwise equal with binary_qmm "
        f"swapped for binary_qmm_ref on the same tensors")
    finite = all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in kern)
    if not finite:
        raise AssertionError("main-path logits not finite or of the wrong shape")

    # ---- phase 4: fused backend on the same model
    pal, fed = greedy_steps(Z, cfg, params, prompt, 8, device)
    fcfg = with_backend(cfg, "fused")
    _zero(all_kernels)
    fus, _ = greedy_steps(Z, fcfg, params, prompt, 8, device, tokens=fed)
    torch.cuda.synchronize()
    launched = _counts(all_kernels)
    if launched != [0, per_forward * 9, 0, 0]:
        raise AssertionError(f"fused pass launches K1, K2, K3, K4 {launched}; expected K2 = "
                             f"{per_forward} x 9 forwards and no other")
    k2 = dict(launches=launched[1], replays=None)
    with mock.patch.object(ops._fq, "fused_qmm", ref.fused_qmm_ref):
        fplain, _ = greedy_steps(Z, fcfg, params, prompt, 8, device, tokens=fed)
    if not all(torch.equal(a, b) for a, b in zip(fus, fplain)):
        raise AssertionError("fused-path logits differ with K2 swapped for its plain version")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (1, cfg.vocab_size) for x in fus):
        raise AssertionError("fused-path logits not finite or of the wrong shape")
    log(f"[4] prefill ({len(prompt)} tokens) + 8 decode steps: logits bitwise equal with fused_qmm "
        f"swapped for fused_qmm_ref on the same tensors and tokens")
    fgap = max(float((a - b).abs().max()) for a, b in zip(fus, pal))
    scale = max(float(b.abs().max()) for b in pal)
    same = sum(int(a.argmax()) == int(b.argmax()) for a, b in zip(fus, pal))
    log(f"[4] fused pass: prefill + 8 decode ticks, fused_qmm launches {k2['launches']} = {per_forward} x 9; "
        f"max |logit - pallas logit| {fgap:.3g} (max |pallas logit| {scale:.3g}), "
        f"argmax equal at {same}/9 steps")
    # where the time goes on the fused backend: the same 4-slot tick, eager
    # and replayed, and prefill that phase 3 profiles for the pallas backend
    k2.update(graph_vs_eager(Z, make_decode_step, fcfg, params, cache, 512, step, K2.fused_qmm,
                             per_forward, phase=4, tag="fused decode tick (4 slots)"))
    report_profile(f"fused eager prefill ({len(long.prompt)} tokens)", *profile_forward(
        lambda: Z.prefill(params, tokens, fcfg, Z.init_slot_cache(512, fcfg, device=device))), phase=4)
    del cache

    del params
    torch.cuda.empty_cache()
    lap("3-4")

    k3 = serve_bitbert(Z, bert_cfg, device, Request, ServeEngine, serve_sequential,
                            make_decode_step, make_prefill, ops, ref, all_kernels)
    lap("5")
    k4 = dict(launches=act_act(device, gen, all_kernels), replays=None, replay_launches=None)
    lap("6")
    k1["gemma3"] = serve_gemma3(Z, gemma3_cfg, device, Request, ServeEngine, serve_sequential,
                                make_decode_step, ops, ref, all_kernels, smi)
    lap("7")
    k1["deepseek"] = serve_deepseek(Z, deepseek_cfg, device, Request, ServeEngine, make_decode_step,
                                    ops, ref, all_kernels, smi, gen)
    lap("8")
    for rcfg in recurrent_cfgs:
        k1[rcfg.name.split("-")[0]] = serve_recurrent(
            Z, rcfg, device, Request, ServeEngine, serve_sequential, make_decode_step, ops, ref,
            all_kernels, smi)
    lap("9")
    internvl_cfg, whisper_cfg = encoder_cfgs
    k1["internvl2"] = serve_internvl(Z, internvl_cfg, device, Request, ServeEngine, serve_sequential,
                                     make_decode_step, make_prefill, ops, ref, all_kernels, smi)
    k1["whisper"] = serve_whisper(Z, whisper_cfg, device, ServeEngine, make_decode_step, make_prefill,
                                  ops, ref, all_kernels, smi)
    lap("10")

    log("[12] the scores kernel against its plain version (B, H, S, dw) x (B, G, T, dw):")
    rows["binary_attn_scores_planes"] = check_binary_attn(gen)
    k5 = serve_binary_attention(Z, bert_cfg, device, Request, ServeEngine, serve_sequential,
                                make_decode_step, make_prefill, ops, ref,
                                all_kernels + (K5.binary_attn_scores_planes,))
    lap("12")

    # ---- phase 13: fault-tolerant serving, snapshots, resume, float serving
    int8_cache = Z.init_cache(4, 512, with_backend(model_cfg, "pallas"), device=device)
    int8_bytes = sum(t.numel() * t.element_size() for layer in int8_cache["layers"] for t in layer.values())
    del int8_cache
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_13_") as workdir:
        k1["robust"], k2["demotion"] = serve_robust(
            Z, model_cfg, device, Request, ServeEngine, serve_sequential, make_decode_step, all_kernels, smi,
            Path(workdir))
    serve_float(Z, model_cfg, device, Request, ServeEngine, serve_sequential, make_decode_step, all_kernels,
                smi, int8_bytes)
    log(f"[13] phase 13 took {time.perf_counter() - t:.1f} s")

    # ---- phase 14: QAT training, and the trained model served through K3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_14_") as workdir:
        k3["trained"] = train_models(Z, bert_cfg, model_cfg, device, ops, ref, all_kernels, smi, Path(workdir))

    # ---- phase 15: QAT of the MoE / MLA and recurrent families, served through K1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_15_") as workdir:
        k1_15, numbers15 = train_families(Z, deepseek_cfg, recurrent_cfgs, device, ops, ref, all_kernels, smi,
                                          Path(workdir))
    k1.update(k1_15)

    # ---- phase 16: QAT of the encoder families and the bf16 variants, served through K1
    k1.update(train_encoders(Z, encoder_cfgs, recurrent_cfgs[0], model_cfg, device, ops, ref, all_kernels, smi,
                             make_prefill, make_decode_step, numbers15.get("recurrentgemma")))

    # ---- phase 17: the measurement modules on the card, the paper's GOPS/W, the examples
    measured = measure_modules(Z, bert_cfg, device, ops, ref, all_kernels + (K5.binary_attn_scores_planes,), smi,
                               make_prefill)
    for path, name in ((k1, "binary_qmm"), (k2, "fused_qmm"), (k3, "popcount_qmm"), (k4, "bitserial_qmm"),
                       (k5, "binary_attn_scores_planes")):
        path.update(measured[name])

    # ---- phase 18: multi-device QAT training (2 ranks on the card, NCCL), served through K3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_18_") as workdir:
        k3["multidevice"], md_numbers = train_multidevice(Z, bert_cfg, model_cfg, device, ops, ref, all_kernels,
                                                          smi, Path(workdir))

    # ---- phase 19: the invariant verifier over the real launches, the self-test, the dry-run
    verified = verify_and_dry_run(Z, model_cfg, bert_cfg, device, all_kernels + (K5.binary_attn_scores_planes,),
                                  smi, md_numbers)

    main_path = {"binary_qmm": k1, "fused_qmm": k2, "popcount_qmm": k3, "bitserial_qmm": k4,
                 "binary_attn_scores_planes": k5}
    for name, path in main_path.items():
        path["verified"] = verified[name]
    sources = {
        "binary_qmm": ("src/repro_torch/csrc/binary_qmm.cu", "src/repro/kernels/binary_qmm.py:95"),
        "fused_qmm": ("src/repro_torch/csrc/fused_qmm.cu", "src/repro/kernels/fused_qmm.py:180"),
        "popcount_qmm": ("src/repro_torch/csrc/popcount_qmm.cu", "src/repro/kernels/popcount_qmm.py:95"),
        "bitserial_qmm": ("src/repro_torch/csrc/bitserial_qmm.cu", "src/repro/kernels/bitserial_qmm.py:83"),
        # the reference's plain jnp scores core (no pallas_call)
        "binary_attn_scores_planes": ("src/repro_torch/csrc/binary_attn.cu",
                                      "src/repro/kernels/binary_attn.py:39"),
    }
    kernels = []
    for name, shapes in rows.items():
        head = shapes[0]
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
            **main_path[name], max_abs_err=max(r["max_abs_err"] for r in shapes),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"], shape=head["shape"],
            shapes=shapes,
        ))
    log(f"[11] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
