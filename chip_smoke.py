#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env      torch / CUDA versions, device count, the card's name and power limit;
2. build    nvcc builds the port's CUDA kernels from csrc/ (seconds, library path);
            per kernel its ptxas registers and spill bytes and its count of
            ``HGMMA`` (wgmma) instructions in ``cuobjdump -sass`` of the built
            library; the Hopper K1/K2/K3 must hold HGMMA and spill nothing;
3. kernels  each flash-attention kernel (K1 forward, K2 dq, K3 dk/dv) against its
            plain PyTorch version, element by element on each row's own scale
            (``TOL``): at the flagship shape (B=8, H=12, T=1024, D=64, bf16,
            causal) on contiguous inputs and on the head-split views of a
            fused [B, T, 3*H*D] qkv projection (read in place, as the train
            step passes them), at a ragged shape (T=200) causal and not in
            bf16 and f32, and at D=128 (``D128``) causal and not; then K1-K3
            and their SDPA yardsticks timed by device time in turns (kernels,
            library, library, kernels; ``device_ms``), contiguous and on the
            qkv view, with plain times and the card's bound for the same work;
            then the same check and timing at each model's main-path shape
            (``MODEL_ATTENTION``: BERT-base (16, 12, 512, 64) and ViT-Tiny
            (32, 3, 65, 64) non-causal on the qkv view, Llama-2-7B (1, 32,
            4096, 128) causal);
4. trainer  ``Trainer(get_model("gpt2_small"), batch_size=8)`` at full width:
            2 warm-up steps, 20 timed steps with finite losses, launch counts of
            24 K1 / 12 K2 / 12 K3 per step; then one fwd/bwd through the kernels
            and through the plain attention core on the same batch and on params
            whose attention is far from uniform, with the loss and every
            gradient leaf compared (``PARITY_TOL``);
5. codec    the bf16 wire kernels (K4 encode, K5 decode-axpy) against their
            plain versions at n = 124,439,808 (gpt2_small's flat buffer),
            524,289 and 1000, with special values (±0, ±inf, NaN of both
            signs and with payloads, subnormals, the largest finite value,
            values that round up to inf): K4 bit-equal on every lane, the
            flat K5 within ``CODEC_TOL``; K4 and ``x.to(bfloat16)`` timed by
            device time in turns, with the bound, and the wall time of one
            ``MeshCodec.encode_bf16`` (numpy in and out) at the flagship n;
            then K5 as the folder calls it, ``bf16_fold_chunks`` against
            ``fold_chunks_plain`` on four staged flushes: the flagship one
            (16 chunks of 1 MiB, repeated tiles, the short tail tile, a zero
            weight), a ragged one at nd = 2 (shards not a multiple of 8, read
            from whole rows at each rank's column: the scalar path), special
            bit patterns, and 600 small chunks whose chunk table splits into
            launches of whole tiles (``k5_launch_range``): bit-equal on
            finite lanes, inf and NaN lanes matching; per flagship flush the
            wrapper's time, the kernel's device time (profiler), the plain
            version's, one ``index_add_`` of the decoded batch and the bound
            (cycling over flushes whose bytes exceed the L2), beside the
            flat K5 per 1 MiB chunk as the first design launched it;
6. averaging two ``Volunteer``s in this process share the card and train
            gpt2_small at full width, averaging every 2 steps in blocking
            sync rounds over localhost TCP on the bf16 wire (``AVG_OVERLAP``
            says why not overlapped). Each volunteer stops after its current
            step, as on SIGTERM, once ``AVG_COMMITS`` rounds have committed,
            with ``AVG_MAX_STEPS`` as the cap: the run ends on a count of
            committed rounds, whatever the host's speed. Checked: at least
            2 committed rounds on each and none degraded (a round one
            volunteer runs alone is skipped, and allowed), at least one
            contribution streamed through the leader's device folder, every
            codec op on the card (no host op), K4 launch counts equal to
            the count the groups formed and the committed rounds imply and K5
            one launch per rank per flush of the leader's folder, as the
            aggregators' ``folder_flushes`` gauge counts them
            (``expected_codec_launches``), one streamed round's results
            within ``AVG_TOL`` of the weighted mean of the two payloads, and
            finite losses.
7. ring_kernels  the ring kernels (K6 reduce-scatter fold, K7 all-gather)
            against their plain versions at nd = 2 and 4 ranks: the first nd
            cards when there are that many, else nd ranks sharing cuda:0
            (printed with ``cross_card``). Four flushes: the flagship one
            (gpt2_small's flat buffer, 1 MiB chunks, 16 chunks with repeated
            tiles, the short tail tile and one zero weight), a ragged one
            (shards not a multiple of 8: the scalar paths), special bit
            patterns, and one of 600 small chunks whose metadata splits it
            into several rings of whole slots. K6 bit-equal on finite lanes
            with inf / NaN lanes matching, K7 bit-equal, the whole fold
            within ``RING_TOL`` of the host fold. Launches, exactly: with
            every rank on one card, K6 one per ring of a flush and K7 one
            per result; across cards, K6 one per card per ring step per ring
            and K7 nd·(nd - 1) per result. Every case is one ring but
            "split", whose rings follow from its metadata words
            (``k6_rings``). Kernel / plain / library times per flush
            (cycling ``FLUSH_SETS`` flagship flushes) and per result, each
            through its wrapper and by the kernels' own device time, the
            K7 design not kept (TMA bulk copies, built from
            ``experiments/torch_ring_variants.cu``), and the bound;
8. dp_parity one full-width f32 step of the dp=2 trainer (two ranks, as in
            7) against the one-rank trainer from the same init and batch:
            every averaged-gradient leaf, the loss and every param leaf's
            update after the step (``PARITY_TOL["dp"]``), identical replicas;
            then the dp=2 trainer's samples/s in bf16;
9. ring_averaging  phase 6 again (at ``DEPTH_CUT``) with both volunteers
            on a dp=2 mesh and ``mesh_collective="ring"``: the leader's streamed rounds fold on
            K6 and gather on K7, no K5 launch, K4 once per rank per encode,
            K6 = one launch per ring flush and K7 = one per ring result with
            both ranks on the one card (nd·(cards in use) and nd·(nd - 1)
            across cards; the codec's gauges), values within ``AVG_TOL``.
10. lifecycle  the flagship volunteer's life from the port's entry scripts:
            ``coordinator_torch.py`` starts; volunteer A runs as a process of
            ``run_volunteer_torch.py`` (gpt2_small at full width, batch 8,
            blocking bf16 sync rounds every ``LIFE_EVERY`` steps, a
            checkpoint every ``LIFE_CKPT_EVERY``) and B in this process,
            both pointed at the coordinator, until each has committed
            ``LIFE_COMMITS`` rounds; A gets SIGTERM and must exit 0 with its
            final ``step_N``; C starts in this process while B is the only
            live provider: C's pull must return a step >= 2, C's trainer
            must hold that step and, bit for bit on the card, the pulled
            tree, which must be bit-equal to B's served snapshot through
            the host bf16 codec (``native.f32_to_bf16``); A restarts from its
            directory, must restore its final step and then pull a fresher
            state from B or C; the three commit ``LIFE_COMMITS`` rounds
            together. Then ``coord.status`` must hold all three (alive,
            telemetry and watchdog summaries) and the coordinator's record
            of their reports the device codec with K4 launches (and K5
            launches at least the folder flushes of the volunteer, some K5
            launch in all), B's and C's codec ops all on the card; finite
            losses; K1-K3 launches 24 / 12 / 12 per step of B and C, K5 as
            their folders' flushes. The line has rounds and round seconds
            per volunteer, the pulls' seconds and bytes, the checkpoint's
            host-copy ms, write and restore seconds, and the coordinator's
            report count.

11. gossip  two ``Volunteer``s in this process, gpt2_small at full width, batch 8,
            ``averaging="gossip"`` in params mode on the bf16 wire, blocking
            rounds every ``PROTO_EVERY`` steps; each publishes its params at
            start; the gather ceiling of these phases is ``PROTO_GATHER_S``
            (several volunteers share this process's event loop). Until
            each has made ``GOSSIP_MIXES`` successful exchanges.
            Checked: that count; each recorded mix against the weighted mean
            of the caller's buffer and the partner's as its
            ``gossip.exchange`` handler served it (``PROTO_STAGES``,
            ``proto_limit``), and the mixed weight their sum; every codec op
            on the card; K4 launches at least two per exchange; K1-K3 24 /
            12 / 12 per step; finite losses.
12. butterfly  ``BFLY_N`` = 4 such volunteers with ``averaging="butterfly"`` on
            the wall-clock cadence (``BFLY_INTERVAL_S``; each runs
            ``ClockSync``), groups of all four, so every round runs both
            hypercube stages, each under ``BFLY_STAGE_S``. Until each has ``BFLY_ROUNDS`` rounds in which
            both stages mixed on time. Checked: those rounds; within a round
            the four results bit-equal and within two bf16 roundings of the
            weighted mean of the four payloads, each weighted by the steps
            since its last merge as ``ProtoRecorder`` counts them (not the
            trainer's own count); every codec op on the card; K4 at least
            16 per full round; the seconds of each round and of each stage.
13. byzantine  two such volunteers and an attacker, a ``run_volunteer_torch.py``
            process with ``DVC_CHAOS_CONTRIB_SCALE=-4`` (``BYZ_SCALE``: its
            real tree scaled by -4), all with ``averaging="byzantine"``,
            ``method="trimmed_mean"`` and ``resilience=True`` (phi detector,
            policy, controller), groups of three, rounds every
            ``PROTO_EVERY`` steps. Until each honest volunteer has
            ``BYZ_ROUNDS`` rounds that all three fed. Checked: those rounds;
            each honest result inside the two honest payloads, widened by
            one bf16 rounding (trim 1 of 3 is the coordinate median), and
            the two honest results of a round bit-equal (both aggregate the
            same three wire-rounded contributions); the aggregate on the
            card, the attacker's codec ops too (no host op); each honest policy recorded
            a rejection of the attacker; each report carries the
            controller's state; the attacker exits 0 on SIGTERM.
14. mnist   capability config 1 through the entry script's default model:
            ``run_volunteer_torch.py`` with no ``--model`` (mnist_mlp) and
            config 1's flags (``MNIST_ARGV``); exit 0 with the target loss
            0.15 crossed.
15. vit     cifar10_vit at its registry config, one volunteer, no averaging,
            ``VIT_STEPS`` steps at batch ``VIT_BATCH``: finite losses, K1-K3
            24 / 12 / 12 per step.
16. resnet_sync  capability config 2: phase 6 with cifar10_resnet18 at its
            registry widths (11.2 M params, GroupNorm), batch 16, lr 0.005,
            rounds every 10 steps (``RESNET``), with phase 6's checks (K4 /
            K5 at the counts the rounds imply, values within ``AVG_TOL``).
17. bert_gossip  capability config 3: phase 11 with four bert_mlm volunteers
            (BERT-base, T 512), batch 16, lr 0.003 (``BERT``), with phase
            11's checks; K1-K3 24 / 12 / 12 per step.
18. llama_byzantine  capability config 5: phase 13 with llama_lora at
            ``LlamaConfig.llama2_7b()`` (vocab 32000, d 4096, 32 heads of 128,
            32 layers, d_ff 11008, LoRA rank 8 on q and v), batch 1 at T
            4096, bf16 params (``LLAMA``; three f32 bases would not fit the
            card), the attacker a process of the entry script with the same
            ``--model-override`` flags; phase 13's checks, and: each
            contribution is the 4,194,304 adapter elements in 8,388,608 wire
            bytes, each full round sends two to three of them, the base is
            bit-unchanged after training on each honest volunteer
            (``bits_fingerprint``), each volunteer's init peak is at most 2
            GiB above the memory it left resident (no whole f32 model on the
            card), K1-K3 64 / 32 / 32 per step; it prints the card's used
            memory at the phase's peak (``CardMemorySampler``).

The trainer's other modes (run after phases 4, 6, 6, 14 and 16):
19. multi_step  gpt2_small at full width, batch 8: ``MULTI_STEPS`` single
            steps and the same from the same init on the same batches at
            ``steps_per_call`` ``MULTI_SPC``; losses and every param leaf
            within ``PARITY_TOL["multi"]`` (bit-equality reported), K1-K3
            24 / 12 / 12 per step in each run, samples/s of both; then
            ``evaluate`` on the held-out stream (K1 12 per batch under
            no_grad, no K2 / K3) and one batch's eval loss through the
            kernels against the plain core (``PARITY_TOL["eval"]``).
20. grad_averaging  phase 6 at ``DEPTH_CUT`` in gradient mode
            (``average_what="grads"``): a
            round every step for ``GRAD_STEPS`` steps, each contribution one
            batch of weight; phase 6's checks with every round's values
            within ``AVG_TOL``, every round committed, K1-K3 per step, and
            the two volunteers' params within ``adam_drift_bound``
            (``GRAD_EPS``).
21. outer_sync  phase 6 at ``DEPTH_CUT`` with the outer Nesterov step (``OUTER``: lr 0.7,
            momentum 0.9) until ``OUTER_COMMITS`` rounds committed on each:
            the merged params on the card bit-equal to a numpy replay of
            the recorded averages (round 1 the plain average), and a
            checkpoint's ``.outer.npz`` sidecar round-tripping bit-equal.
22. mnist_file  capability config 6: ``run_volunteer_torch.py`` on a file of
            ``experiments/make_npz.py --task mnist`` (``MNIST_FILE_ARGV``):
            exit 0, the target crossed, a finite ``eval`` event at every
            multiple of 50.
23. resnet_file  capability config 7: phase 16 with both volunteers on a
            ``--task cifar10`` file (per-peer shuffles), phase 6's checks.

The volunteer under faults and on a zoned schedule (run after phase 13):
24. zones   four full-width volunteers in this process in zones ``ZONES``
            (a, a, b, b) on the zoned group schedule: groups of 2, rotations
            every ``ZONE_ROTATION_S`` on the wall clock, every
            ``ZONE_K``-th rotation across zones; blocking bf16 sync rounds
            every ``AVG_EVERY`` steps. Until each has committed
            ``ZONE_COMMITS`` (2 intra-zone, 1 cross-zone) rounds. Checked:
            intra groups inside one zone with no ``sync.*`` byte across
            zones and ``zone_traffic()``'s cross-zone bytes under
            ``ZONE_CTRL_BYTES`` during the round; cross groups spanning both
            zones; a round of each level within ``AVG_TOL``; K1-K3 24 / 12
            / 12 per step; K4 and K5 at the counts the rounds imply.
25. failover  a sync leader SIGKILLed mid-stream across processes: a
            ``coordinator_torch.py`` process and three full-width
            ``run_volunteer_torch.py`` processes; ``a0`` (``--min-group 3``,
            ``DVC_CHAOS_LEADER_DIE_PHASE=mid_stream``) first, then ``b1``
            and ``c2`` (``--min-group 2``). Checked: ``a0`` exits by
            SIGKILL; the survivors depose it, one recovers the round, each
            commits after it and exits 0 on SIGTERM; their codec stats all
            on the device (K5 launches equal to their folders' flushes, some
            K5 launch); K1-K3 per step from their ``VOLUNTEER_DONE``.
26. hedge   hedged tile recovery at full width: a leader and two members
            (``SyncAverager``s on ``ChaosTransport``s, the device codec), a
            gpt2_small-sized flat buffer each, one member's push on a thin
            link that would land past the round deadline; with
            ``hedge=True`` the refetched tiles fold on K5 and the result is
            within ``AVG_TOL`` of the weighted mean of all three, with
            ``hedge=False`` of the other two; round seconds and lost mass of
            both arms.

The compressed wires and zone sharding (run after phase 26), gpt2_small at
full width and ``DEPTH_CUT``, batch 8:
27. wires   two volunteers per arm in blocking sync rounds (``WIRE_ARMS``):
            q8 averaging params every 2 steps, topk (1%) gradients every
            step; at least 2 committed rounds each; every contribution's
            wire bytes those of the averaged subtree's element count; each
            round within ``WIRE_TOL`` (leader against the weighted mean of
            the contributions as peers decode them, member against the
            leader); on topk the error-feedback residual bit-equal to ``x -
            topk_decode(topk_encode(x))`` and banked on commit; K1-K3 per
            step, no K4 or K5.
28. psgd_byzantine  config 8's PowerSGD arm: phase 13's swarm in gradient
            mode on ``--wire powersgd --psgd-rank 4``, ``trim`` 1, the
            attacker at ×−3, each honest volunteer on a codec of its own; in
            each round all three fed, the aggregate bit-equal to the median
            of the three decoded rows, the policies' rejections exactly the
            rows past the reference's bar, both honest results bit-equal to
            it; each honest codec's power iteration and reconstructions run
            on the card (its ``low_rank_calls``); no K4 or K5; per round the
            attacker's distance ratio, k and the honest cosine.
29. sign_byzantine  config 8's sign arm, the same on ``--wire sign``
            (three volunteers, no kill: PERF.md section 4).
30. zone_shards  four volunteers in zones a, a, b, b with ``zone_shards``
            2, groups of 2, every rotation across zones: maps agree within
            each zone, each volunteer owns and advertises its HRW shard,
            every round's group id carries its members' shard, values within
            ``AVG_TOL``, K4 and K5 as the rounds imply; then a zone-a holder
            leaves, its partner re-shards and recovers (``shard_recovered``
            with its source and latency), and zone b's shard snapshots
            assemble bit-equal to the held slices.

The volunteer's model-parallel mesh and gpt2_moe (run last; ranks share
cuda:0 by ``make_mesh(devices=...)``; f32 for the parity checks):
31. mesh_step  gpt2_small at published widths, 12 layers, batch 8, T 1024:
            from one init and one batch, 2 AdamW steps on one rank (the
            reference) and on each layout of ``MESH_LAYOUTS`` (dp=2,tp=2;
            dp=2 with ZeRO-1; dp=2,tp=2 with FSDP; dp=2,tp=2 in grads mode:
            grad step then apply step): the loss, every gradient leaf and
            each leaf's update after the first step within
            ``PARITY_TOL["dp"]`` (the key bias reported only); every rank's
            resident param and moment bytes equal to what the specs imply,
            printed per rank; K1-K3 launches of the second step at the ranks
            that attend (dp·tp) times a rank's 24 / 12 / 12, at the H/tp head
            split; samples/s per layout (f32, not bounded). Each layout's
            state is freed before the next.
32. moe     gpt2_moe at its published widths (GPT-2 small's, 12 layers, E 8,
            d_ff 3072 per expert, capacity factor 1.25), batch 8, T 1024,
            against one rank: top-1 on ep=2,tp=2 and top-2 on dp=2,ep=2,tp=2
            (``MOE_MESHES``). The first step's loss, lm_loss and aux_loss
            within ``MOE_TOL["loss"]``, each leaf's update within
            ``MOE_TOL["update_l2"]``, the share of routing decisions (token,
            layer, choice: the expert and whether it kept a slot) that
            differ from one rank's at most ``MOE_TOL["routing"]``, the expert
            leaves at 1/(ep·tp) of their bytes on every rank, K1-K3 at dp·tp
            times a rank's count; the dropped-token share per layer and
            samples/s printed.
33. mesh_swarm  a coordinator and two ``run_volunteer_torch.py`` processes
            (gpt2_moe at published widths, ``DEPTH_CUT``): A on ``--mesh
            ep=2,tp=2``, B on ``--mesh dp=2 --fsdp``, blocking sync rounds
            on the bf16 wire. Each runs under a recorder
            (``mesh_swarm_child``: this script, in the child, around the
            entry script's ``main``), which also puts its mesh's ranks on
            cuda:0 (``mesh_of``). Each commits
            ``MESH_SWARM_COMMITS`` rounds with equal schema hashes, every
            round within ``AVG_TOL`` of the weighted mean of the two
            contributions (on every ``MESH_SWARM_STRIDE``-th element; the
            rounds paired by their group's epoch, the leader named by the
            group both recorded), after
            each merge every rank's slices equal to the merged payload's,
            and both exit 0 on SIGTERM with a final ``step_N``.

Each phase also prints ``{"phase_wall": name, "seconds": s, "ok": bool}``
when it ends. Then one line listing every kernel (``launches_lifecycle``: the counts of
phase 10, ``launches_protocols`` those of phases 11-13, ``launches_models``
those of phases 15-18, ``launches_trainer_modes`` those of phases 19-23,
``launches_faults`` those of phases 24-26 (failover: the survivors'
processes' counts from their summaries), ``launches_wires`` those of
phases 27-30, ``launches_mesh`` those of phases 31-32 (33's are the
children's own), ``shapes_models`` K1-K3 at the models' shapes, the
tensor-parallel head split's among them),
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script
exits non-zero and prints no ``ok`` line. It needs one card and no network.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FLAGSHIP = (8, 12, 1024, 64)
RAGGED_T = 200
D128 = (2, 8, 1024, 128)  # llama-7b's head width
# Kernel vs plain version, element by element, each output row on its own
# scale: |kernel - plain| <= atol + rtol * max|plain row|, where a row is one
# query row of O / dq and one key row of dk / dv. Per row, so a late causal
# row (|O| ~ 0.1) is held as tightly as row 0 (|O| ~ 3). atol only covers rows
# whose exact value is 0 (dq of causal row 0 is rounding noise on both sides).
# lse is held in absolute terms.
TOL = {  # dtype -> (rtol, atol, lse atol)
    torch.bfloat16: (2e-2, 2e-5, 1e-4),  # rtol: 2.5 bf16 ulps of the row's max
    torch.float32: (1e-5, 1e-6, 1e-5),
}
# Full-width train step, kernels vs plain core, in f32 and in bf16, per
# gradient leaf: ``leaf_l2`` bounds ||kernels - plain|| / ||plain||,
# ``leaf_max`` bounds max |kernels - plain| / max |plain|; ``loss`` bounds
# the loss's relative difference. In bf16 the plain core rounds dP and P to
# bf16 where the kernels keep f32, so leaves differ by up to ~2e-2; there
# ``vs_plain`` bounds how much farther than the plain core the kernels may
# land from the f32 plain result. Set from readings on an H100 (PERF.md):
# f32 leaves within 1.8e-6, bf16 leaves within 2.5e-2, and the bf16 kernels
# within 0.2% of the plain core's distance from f32.
PARITY_TOL = {
    "dp": {"loss": 1e-6, "leaf_l2": 1e-5, "leaf_max": 1e-5, "update_l2": 1e-3},
    "f32": {"leaf_l2": 1e-5, "leaf_max": 1e-5, "loss": 1e-6},
    "bf16": {"leaf_l2": 5e-2, "leaf_max": 5e-2, "loss": 1e-5, "vs_plain": 1.1},
}
QK_SCALE = 4.0  # qkv's q/k columns are scaled so attention is far from uniform
KERNELS = {  # name -> (TPU kernel it replaces, what it computes)
    "flash_fwd": ("distributedvolunteercomputing_tpu/ops/pallas_attention.py:94", "K1"),
    "flash_dq": ("distributedvolunteercomputing_tpu/ops/pallas_attention.py:197", "K2"),
    "flash_dkv": ("distributedvolunteercomputing_tpu/ops/pallas_attention.py:240", "K3"),
}
SOURCE = "distributedvolunteercomputing_tpu_torch/csrc/flash_attention.cu"
CODEC_SOURCE = "distributedvolunteercomputing_tpu_torch/csrc/bf16_codec.cu"
CODEC_KERNELS = {  # name -> (TPU kernel it replaces, id)
    "bf16_encode": ("distributedvolunteercomputing_tpu/ops/mesh_codec.py:137", "K4"),
    "bf16_fold_chunks": ("distributedvolunteercomputing_tpu/ops/mesh_codec.py:145", "K5"),
}
FLAT_N = 124_439_808  # gpt2_small's parameters, the averaged flat buffer
CHUNK_N = (1 << 20) // 2  # one 1 MiB bf16 wire chunk: what one K5 launch folded in the first design
CODEC_SIZES = (FLAT_N, 524_289, 1000)
# K5's chunk table (csrc/bf16_codec.cu kFoldWords): int32 words per launch,
# 3 per tile, 3 per chunk and one more.
K5_FOLD_WORDS = 2032
FLUSH_SETS = 4  # staged flushes cycled when timing K5, disjoint in tiles and bits: their bytes exceed the L2
# K5 against its plain version: the reference's own limit for the fold
# (tests/test_mesh_codec.py); both sides round the product and the sum once,
# so they are expected to agree bit for bit.
CODEC_TOL = {"rtol": 1e-5, "atol": 1e-6}
# Averaged values on the card. The leader's result is the f32 weighted mean of
# the two bf16-rounded contributions: within one bf16 rounding (unit roundoff
# 2^-8) of max(|x0|, |x1|) of the exact mean, plus an f32 floor (a few f32
# ulps of the same scale, and the smallest normal). The member fetches that
# result over the bf16 wire: within one bf16 rounding of the leader's.
AVG_TOL = {"bf16_u": 2.0**-8, "f32_ulps": 4 * 2.0**-24, "floor": 2.0**-126}
# Protocol results on the bf16 wire (phases 11-13). A mixing stage rounds each of its inputs
# to bf16 once (AVG_TOL's bf16_u of the stage's scale, at most the largest
# input's) and mixes them in f32 (f32_ulps): a result of s stages is within
# (s * bf16_u + f32_ulps) * max_i |x_i| + floor of the exact weighted mean of
# the inputs x_i (``proto_limit``). Gossip mixes its own f32 buffer with the
# partner's bf16 one: one stage. Butterfly round-trips both sides of each of
# its two stages: two. The Byzantine median of three is one of the three
# bf16-rounded payloads: with the attacker outside, within one bf16 rounding
# (and the floor) of the honest pair's interval.
PROTO_STAGES = {"gossip": 1, "butterfly": 2}
# Ring (K6 / K7): rank counts checked on the card, and the whole fold
# against native's host fold, which adds in batch order where the ring adds
# in ring order: the reference's own tolerance for its ring
# (tests/test_mesh_collective.py). Kernel vs plain version is bit-equal.
RING_NDS = (2, 4)
RING_TOL = {"rtol": 1e-5, "atol": 1e-6}
# K6's parameter block (csrc/ring_collective.cu kFoldMaxRanks, kFoldMetaWords):
# ranks per launch and int32 metadata words per launch.
K6_MAX_RANKS = 8
K6_META_WORDS = 896
RING_SOURCE = "distributedvolunteercomputing_tpu_torch/csrc/ring_collective.cu"
RING_KERNELS = {  # name -> (TPU kernel it replaces, id)
    "ring_fold": ("distributedvolunteercomputing_tpu/ops/mesh_collective.py:87", "K6"),
    "ring_allgather": ("distributedvolunteercomputing_tpu/ops/mesh_collective.py:203", "K7"),
}
# bf16 bit patterns put at the start of every chunk of the "special" case:
# ±0, ±inf, NaNs, subnormals (smallest, largest), the smallest normal and
# the largest finite value of both signs.
RING_SPECIAL_BF16 = (0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81,
                     0x0001, 0x8001, 0x007F, 0x0080, 0x7F7F, 0xFF7F)
# dp=2 vs one rank, one f32 step from the same init and batch
# (PARITY_TOL["dp"]): the loss, and every leaf of the averaged gradient as
# the f32 trainer parity holds it (the two sum the batch in different
# orders); then every param leaf after one clipped AdamW step at DP_LR, held
# by its update: ||u_dp - u_one|| / ||u_one|| per leaf. Not elementwise:
# Adam's first update is lr * g / (|g| + eps), which turns a gradient
# difference d of an element with |g| near eps into up to lr * d / eps (this
# phase's row on an H100: param_leaf max_abs_diff up to 6.5e-5 = 0.065 lr,
# with every grad_leaf within 1.9e-6). The key bias is left out of it: its exact gradient is 0,
# both sides hold rounding noise that Adam turns into updates of up to ~lr
# of either sign.
DP_LR = 1e-3
# Published dense peaks (NVIDIA data sheets): bytes/s, bf16 FLOP/s, f32 FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12), "H100": (3.35e12, 989e12, 67e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}; add them to PEAKS")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, trials: int = 3) -> dict:
    """Device time per call of ``reps`` back-to-back calls of ``fn``: a spin
    kernel holds the stream while all of them are enqueued, so the events
    bracket device work only, not host dispatch (Python, autograd, the
    wrappers' tensor maps). The spin is sized from the measured enqueue time
    and read back: ``held`` says it outlasted the enqueue. Median of
    ``trials``, with the host's enqueue time per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(max(4.0, 3 * enqueue_ms) * 2e6)  # ~2 GHz: 3x the enqueue, 4 ms at least
    times, spins, enqueues = [], [], []
    for _ in range(trials):
        for _attempt in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            torch.cuda._sleep(cycles)
            ev[1].record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            enq = (time.perf_counter() - t0) * 1e3
            ev[2].record()
            torch.cuda.synchronize()
            spin = ev[0].elapsed_time(ev[1])
            if spin > enq:
                break
            cycles *= 2
        times.append(ev[1].elapsed_time(ev[2]) / reps)
        spins.append(spin)
        enqueues.append(enq)
    return {"ms": statistics.median(times), "all_ms": times, "reps": reps,
            "enqueue_us_per_call": statistics.median(enqueues) / reps * 1e3,
            "spin_ms": min(spins), "held": all(s > e for s, e in zip(spins, enqueues))}


def attention_inputs(shape, dtype, layout: str, seed: int = 1234):
    """(q, k, v, dO) [B, H, T, D] on the card. ``contiguous``: four tensors of
    their own. ``qkv``: q, k, v are the head-split views of one fused
    [B, T, 3*H*D] projection and dO the head-split view of a [B, T, H*D]
    gradient, as the train step hands them to the kernels."""
    from distributedvolunteercomputing_tpu_torch.ops.attention import split_heads

    b, h, t, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "contiguous":
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
    q, k, v = (split_heads(x, h) for x in qkv.split(h * d, dim=-1))
    do = split_heads(torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype), h)
    return q, k, v, do


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def row_check(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> dict:
    """``got`` against ``want`` [B, H, T, D] row by row (see ``TOL``).

    ``limit_used`` is the largest |error| / (atol + rtol * row scale): the
    check passes iff it is at most 1. ``worst_row_rel`` is the largest
    |error| / row scale over rows whose scale is above atol / rtol."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(-1, keepdim=True)
    used = (err / (atol + rtol * scale)).max().item()
    row_err = err.amax(-1, keepdim=True)
    live = scale > atol / rtol
    worst_rel = (row_err[live] / scale[live]).max().item() if live.any() else 0.0
    return {"limit_used": used, "worst_row_rel": worst_rel, "min_row_scale": scale.min().item()}


def attention_work(shape, dtype, causal, peak) -> dict:
    """Per kernel: FLOPs, bytes (each input read once, each output written
    once) and the card's bound for them, for this shape's (query, key)
    pairs that the mask keeps."""
    b, h, t, d = shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor_bytes = b * h * t * d * torch.finfo(dtype).bits // 8
    row_bytes = b * h * t * 4
    mem_rate, bf16_rate, f32_rate = peak
    op_rate = bf16_rate if dtype == torch.bfloat16 else f32_rate
    out = {}
    for name, flops, nbytes in (
        ("flash_fwd", 4 * d * pairs, 4 * tensor_bytes + row_bytes),
        ("flash_dq", 6 * d * pairs, 5 * tensor_bytes + 2 * row_bytes),
        ("flash_dkv", 8 * d * pairs, 6 * tensor_bytes + 2 * row_bytes),
    ):
        bytes_ms, ops_ms = nbytes / mem_rate * 1e3, flops / op_rate * 1e3
        out[name] = {"bound_ms": max(bytes_ms, ops_ms), "bound_us": max(bytes_ms, ops_ms) * 1e3,
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "flops": flops, "bytes": nbytes}
    return out


def attention_runs(fa, q, k, v, do, causal):
    """name -> (kernel call, plain call) on the same inputs."""
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    return {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal), lambda: fa.flash_fwd_plain(q, k, v, causal)),
        "flash_dq": (
            lambda: fa.flash_dq(q, k, v, do, lse_ref, delta, causal),
            lambda: fa.flash_dq_plain(q, k, v, do, lse_ref, delta, causal),
        ),
        "flash_dkv": (
            lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta, causal),
            lambda: fa.flash_dkv_plain(q, k, v, do, lse_ref, delta, causal),
        ),
    }


def check_kernels(fa, shape, dtype, causal, peak, layout: str = "contiguous"):
    """Each kernel against its plain version on the same inputs."""
    q, k, v, do = attention_inputs(shape, dtype, layout)
    in_place = all(fa.kernel_layout(x) is x for x in (q, k, v, do))
    if not in_place:
        raise AssertionError(f"{layout} inputs at {shape} would be copied before the kernels")
    runs = attention_runs(fa, q, k, v, do, causal)
    work = attention_work(shape, dtype, causal, peak)
    rtol, atol, lse_atol = TOL[dtype]
    results = {}
    for name, (kernel, plain) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        outs = ("o", "lse") if name == "flash_fwd" else ("dq",) if name == "flash_dq" else ("dk", "dv")
        checks = {}
        for out, a, w in zip(outs, got, want):
            if out == "lse":
                checks[out] = {"max_abs_err": abs_err(a, w), "atol": lse_atol}
                checks[out]["limit_used"] = checks[out]["max_abs_err"] / lse_atol
            else:
                checks[out] = row_check(a, w, rtol, atol)
        row = {
            "phase": "kernel_check", "kernel": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "causal": causal, "layout": layout, "strides": [list(x.stride()) for x in (q, k, v, do)],
            "in_place": in_place, "max_abs_err": max(abs_err(a, w) for a, w in zip(got, want)),
            "rtol": rtol, "atol": atol, "checks": checks, **work[name],
        }
        finite = all(torch.isfinite(a).all() for a in got)
        emit(row)
        if not finite or not all(c["limit_used"] <= 1.0 for c in checks.values()):
            raise AssertionError(
                f"{name} disagrees with its plain version at {shape} {dtype} causal={causal} {layout}"
            )
        results[name] = row
    return results


DEVICE_MS_METHOD = ("device time per call: back-to-back calls enqueued while a spin kernel holds the stream, "
                    "CUDA events around the calls only (chip_smoke.device_ms)")


def time_attention(fa, peak, reps: int = 40, shape=FLAGSHIP, causal: bool = True,
                   layouts=("contiguous", "qkv")) -> dict:
    """K1-K3 and their SDPA yardsticks at ``shape`` (the flagship's by
    default) by device time (``device_ms``), in turns in this one call:
    kernels, library, library, kernels; for each of ``layouts``. Plain
    versions once each."""
    import torch.nn.functional as F

    out = {}
    for layout in layouts:
        q, k, v, do = attention_inputs(shape, torch.bfloat16, layout)
        runs = attention_runs(fa, q, k, v, do, causal)
        qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))

        def sdpa_fwd():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            torch.autograd.grad(o, (qs, ks, vs), do)

        library = {"sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd}
        readings = collections.defaultdict(list)
        order = list(runs) + list(library) + list(library)[::-1] + list(runs)[::-1]
        for name in order:
            fn = runs[name][0] if name in runs else library[name]
            readings[name].append(device_ms(fn, reps if name in runs else reps // 2))
        row = {"phase": "kernel_times", "layout": layout, "shape": list(shape), "causal": causal,
               "method": DEVICE_MS_METHOD, "order": order}
        for name, rs in readings.items():
            row[name] = {"ms": statistics.mean(r["ms"] for r in rs), "readings_ms": [r["ms"] for r in rs],
                         "enqueue_us_per_call": [r["enqueue_us_per_call"] for r in rs],
                         "spin_held": all(r["held"] for r in rs)}
        if layout == "contiguous":
            for name, (_, plain) in runs.items():
                row[name]["plain_ms"] = device_ms(plain, 5, trials=1)["ms"]
        emit(row)
        if not all(r["spin_held"] for r in row.values() if isinstance(r, dict)):
            raise AssertionError(f"the spin did not outlast the enqueue: {row}")
        out[layout] = row
        del q, k, v, do, qs, ks, vs, runs
    torch.cuda.empty_cache()
    return out


def trainer_phase(fa, steps_warm: int = 2, steps_timed: int = 20):
    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer

    bundle = get_model("gpt2_small")
    cfg = bundle.config
    metrics_path = HERE / "build" / "chip_smoke" / "metrics.jsonl"
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    metrics_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    trainer = Trainer(bundle, batch_size=8, total_steps=steps_warm + steps_timed, metrics_path=str(metrics_path))
    init_s = time.perf_counter() - t0
    warm = trainer.run(steps=steps_warm, log_every=0)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.run(steps=steps_timed, log_every=0)
    launches = dict(fa.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [json.loads(line)["loss"] for line in metrics_path.read_text().splitlines()]
    expect = {"flash_fwd": 24 * steps_timed, "flash_dq": 12 * steps_timed, "flash_dkv": 12 * steps_timed}
    row = {
        "phase": "trainer", "model": bundle.name, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "n_layers": cfg.n_layers, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "seq_len": cfg.max_len,
        "batch_size": 8, "remat": cfg.remat, "init_s": init_s, "warmup_wall_s": warm["wall_time_s"],
        "losses": losses, "timed_steps": steps_timed, "samples_per_sec": summary["samples_per_sec"],
        "step_ms": summary["wall_time_s"] / steps_timed * 1e3,
        "max_memory_allocated": peak_mem, "launches": launches, "launches_expected": expect,
    }
    emit(row)
    if len(losses) != steps_warm + steps_timed or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    parity_phase(bundle, trainer)
    return launches


def leaf_names(tree, prefix: str = "") -> list:
    """Leaf paths in the port's flattening order (sorted keys, depth first)."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree) for n in leaf_names(tree[key], f"{prefix}{key}/")]
    return [prefix.rstrip("/")]


def leaf_diff(got, want, names) -> dict:
    """Per gradient leaf: ||got - want|| / ||want|| and max |got - want| / max |want|."""
    out = {}
    for name, a, b in zip(names, got, want):
        diff, ref = a.float() - b.float(), b.float()
        out[name] = {
            "l2": (diff.norm() / ref.norm().clamp_min(1e-30)).item(),
            "max": (diff.abs().max() / ref.abs().max().clamp_min(1e-30)).item(),
        }
    return out


def parity_phase(bundle, trainer) -> None:
    """Full-width fwd/bwd through the kernels and through the plain core on
    the same params and batch, in f32 and in bf16; every gradient leaf and
    the loss compared (``PARITY_TOL``).

    The trained params are still close to init, where attention is nearly
    uniform and a wrong kernel barely moves the loss. So the q and k columns
    of every layer's qkv weight are scaled by ``QK_SCALE``: layer 0's scores
    then spread over several units and each row's softmax has a clear peak.
    The f32 pass holds the kernels' f32 path tightly. The bf16 pass is the
    main path's dtype; there the two sides round at different points, so each
    is also held against the f32 plain result, and the kernels must be no
    farther from it than ``vs_plain`` times the plain core."""
    from distributedvolunteercomputing_tpu_torch.models import common
    from distributedvolunteercomputing_tpu_torch.models.gpt2 import embed
    from distributedvolunteercomputing_tpu_torch.ops.attention import set_attention_impl, split_heads
    from distributedvolunteercomputing_tpu_torch.training.steps import grad_half
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import compute_dtype_as

    cfg = bundle.config
    params = dict(trainer.state.params)
    blocks = dict(params["blocks"])
    qkv_w = blocks["qkv"]["w"].clone()
    qkv_w[..., : 2 * cfg.d_model] *= QK_SCALE
    blocks["qkv"] = {**blocks["qkv"], "w": qkv_w}
    params["blocks"] = blocks
    state = dataclasses.replace(trainer.state, params=params)
    batch = trainer._to_device(bundle.make_batch(torch.Generator().manual_seed(99), 8))

    with torch.no_grad():  # how far from uniform layer 0's attention is
        p0 = {k: {n: t[0] for n, t in v.items()} for k, v in blocks.items()}
        h = common.layernorm(p0["ln1"], embed(params, batch["tokens"], cfg))
        q, k, _ = common.dense(p0["qkv"], h).split(cfg.d_model, dim=-1)
        s = split_heads(q, cfg.n_heads).float() @ split_heads(k, cfg.n_heads).float().transpose(-1, -2)
        s = s / math.sqrt(cfg.d_model // cfg.n_heads)
        above = torch.ones_like(s, dtype=torch.bool).triu(1)
        probs = torch.softmax(s.masked_fill(above, -1e30), dim=-1)
        layer0 = {
            "score_std": s[~above].std().item(),
            "mean_row_max_prob": probs.amax(-1)[..., 64:].mean().item(),  # rows with >= 65 keys
            "uniform_row_max_prob": (1.0 / torch.arange(65, cfg.max_len + 1, device=s.device)).mean().item(),
        }
        del s, probs, above

    runs = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for side, impl in (("kernels", "auto"), ("plain", "xla")):
                set_attention_impl(impl)
                with compute_dtype_as(dtype):
                    grads, m = grad_half(bundle.loss_fn, state, batch)
                runs[side, dtype] = (grads, float(m["loss"]))
    finally:
        set_attention_impl("auto")
    names = leaf_names(params)
    failures = []
    row = {"phase": "trainer_parity", "qk_scale": QK_SCALE, "layer0_attention": layer0, "tol": PARITY_TOL}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        (g_k, loss_k), (g_p, loss_p) = runs["kernels", dtype], runs["plain", dtype]
        tol = PARITY_TOL[key]
        leaves = leaf_diff(g_k, g_p, names)
        res = {
            "loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
            "leaf": leaves,
            "worst": {kind: max((e[kind], n) for n, e in leaves.items()) for kind in ("l2", "max")},
        }
        if not all(torch.isfinite(g).all() for g in g_k) or not res["loss_rel_diff"] <= tol["loss"]:
            failures.append(f"{key} loss")
        failures += [f"{key} {n} {kind}" for n, e in leaves.items() for kind in ("l2", "max")
                     if not e[kind] <= tol[f"leaf_{kind}"]]
        if dtype == torch.bfloat16:
            ref = runs["plain", torch.float32][0]
            to_k, to_p = leaf_diff(g_k, ref, names), leaf_diff(g_p, ref, names)
            res["to_f32_plain"] = {n: {"kernels": to_k[n]["l2"], "plain": to_p[n]["l2"]} for n in names}
            ratio = max(to_k[n]["l2"] / max(to_p[n]["l2"], 1e-30) for n in names)
            res["worst_ratio_to_f32"] = ratio
            if not ratio <= tol["vs_plain"]:
                failures.append(f"bf16 kernels {ratio:.3g}x farther from f32 than the plain core")
        row[key] = res
    emit(row)
    if failures:
        raise AssertionError(f"full-width train step through the kernels disagrees with the plain core: {failures}")


# ---------------------------------------------------------------------------
# codec: K4 / K5 against their plain versions
# ---------------------------------------------------------------------------

SPECIAL_BITS = (
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000,  # ±0, ±inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,  # NaN of both signs
    0x7FFFFFFF, 0xFFFFFFFF, 0x7FA00000,  # NaN with payload bits
    0x00000001, 0x807FFFFF, 0x00008000, 0x00018000, 0x00017FFF,  # subnormals (ties too)
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,  # max finite, -> inf, stays finite
    0x3F808000, 0x3F818000,  # ties to even
)


def codec_inputs(n: int, gen: torch.Generator):
    """(x f32 [n], acc f32 [n]) on the card: normal values at a spread of
    scales, the special values first, random bit patterns (every exponent,
    NaNs included) in the first 64 Ki lanes."""
    import numpy as np

    x = torch.randn(n, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-40, 40, (n,), generator=gen, device="cuda").float()
    )
    k = min(n, 1 << 16)
    rand_bits = torch.randint(-(2**31), 2**31, (k,), generator=gen, device="cuda", dtype=torch.int64)
    x[:k] = rand_bits.to(torch.int32).view(torch.float32)
    special = torch.from_numpy(np.array(SPECIAL_BITS, np.uint32).view(np.int32)).cuda().view(torch.float32)
    m = min(n, special.numel())
    x[:m] = special[:m]
    acc = torch.randn(n, generator=gen, device="cuda")
    return x, acc


def time_cold_ms(fn_for, n_sets: int, iters: int = 20) -> float:
    """Median per-call time cycling over ``n_sets`` input sets whose total
    exceeds the 50 MB L2, so each call finds its inputs in device memory as
    the main path does."""
    for i in range(n_sets):
        fn_for(i)
    torch.cuda.synchronize()
    times = []
    for it in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn_for(it % n_sets)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def codec_phase(peak) -> dict:
    import numpy as np

    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc

    mem_rate, _, f32_rate = peak
    gen = torch.Generator(device="cuda").manual_seed(4321)
    w = 0.37
    results = {}
    for n in CODEC_SIZES:
        x, acc = codec_inputs(n, gen)
        bits_k, bits_p = mc.bf16_encode(x), mc.encode_bf16_plain(x)
        torch.cuda.synchronize()
        bad = (bits_k != bits_p).sum().item()
        enc_err = (bits_k.int() - bits_p.int()).abs().max().item()
        fold_k, fold_p = mc.bf16_decode_axpy(acc, bits_p, w), mc.decode_axpy_plain(acc, bits_p, w)
        torch.cuda.synchronize()
        # Finite lanes within CODEC_TOL; inf and NaN lanes (from inf / NaN
        # bits) must match exactly.
        fin = torch.isfinite(fold_p)
        same = (fold_k == fold_p) | (torch.isnan(fold_k) & torch.isnan(fold_p))
        fold_err = (fold_k[fin] - fold_p[fin]).abs()
        fold_used = (fold_err / (CODEC_TOL["atol"] + CODEC_TOL["rtol"] * fold_p[fin].abs())).max().item()
        row = {
            "phase": "codec", "n": n, "encode_lanes_differing": bad, "encode_max_abs_err": enc_err,
            "nan_lanes": int(torch.isnan(x).sum().item()), "nonfinite_fold_lanes": int((~fin).sum().item()),
            "fold_max_abs_err": fold_err.max().item(), "fold_limit_used": fold_used,
            "fold_nonfinite_lanes_match": bool(same[~fin].all().item()), "fold_tol": CODEC_TOL,
        }
        if bad or enc_err or not fold_used <= 1.0 or not row["fold_nonfinite_lanes_match"]:
            emit(row)
            raise AssertionError(f"codec kernels disagree with their plain versions at n={n}")
        # In place, as the folder calls it.
        inplace = acc.clone()
        mc.bf16_decode_axpy(inplace, bits_p, w, out=inplace)
        torch.cuda.synchronize()
        if not bool(((inplace == fold_k) | (torch.isnan(inplace) & torch.isnan(fold_k))).all().item()):
            raise AssertionError(f"in-place K5 differs from out-of-place at n={n}")
        if n == FLAT_N:
            # K4 at the flagship n (the contribution and result encodes),
            # kernel and library by device time in turns: kernel, library,
            # library, kernel.
            enc_bytes = 6 * n
            calls = {"ms": lambda: mc.bf16_encode(x), "library_ms": lambda: x.to(torch.bfloat16).view(torch.int16)}
            turns = {key: [] for key in calls}
            for key in ("ms", "library_ms", "library_ms", "ms"):
                turns[key].append(device_ms(calls[key], reps=10)["ms"])
            row["K4"] = {
                "n": n, **{key: statistics.median(v) for key, v in turns.items()},
                "turns_ms": turns, "ms_method": DEVICE_MS_METHOD,
                "plain_ms": time_ms(lambda: mc.encode_bf16_plain(x), iters=5),
                "library_call": "x.to(torch.bfloat16).view(torch.int16) (NaN bits differ: 0xffff)",
                "bytes": enc_bytes, "flops": 0,
                "bound_ms": enc_bytes / mem_rate * 1e3, "bound_by": "bytes",
            }
            # The flat K5 over the whole buffer, and per 1 MiB chunk (one
            # launch of the first design's folder), cycling over enough
            # chunks to leave the L2; in place on a copy of acc, as the
            # folder folded (out of place adds the wrapper's copy of acc).
            fold_bytes, fold_flops = 10 * n, 2 * n
            scratch = acc.clone()
            whole = {
                "n": n, "ms": time_ms(lambda: mc.bf16_decode_axpy(scratch, bits_p, w, out=scratch)),
                "plain_ms": time_ms(lambda: mc.decode_axpy_plain(acc, bits_p, w), iters=5),
                "library_ms": time_ms(lambda: torch.add(acc, bits_p.view(torch.bfloat16), alpha=w)),
                "bytes": fold_bytes, "flops": fold_flops,
                "bound_ms": max(fold_bytes / mem_rate, fold_flops / f32_rate) * 1e3,
            }
            sets = 16  # 16 x 5.24 MB = 84 MB > L2: each call finds its chunk in device memory
            views = [(scratch[i * CHUNK_N : (i + 1) * CHUNK_N], bits_p[i * CHUNK_N : (i + 1) * CHUNK_N])
                     for i in range(sets)]
            cycle = itertools.cycle(views)

            def chunk_ms(fn):
                return device_ms(lambda: fn(*next(cycle)), reps=4 * sets, trials=5)["ms"]

            cb, cf = 10 * CHUNK_N, 2 * CHUNK_N
            chunk = {
                "n": CHUNK_N,
                "ms": chunk_ms(lambda a, bits: mc.bf16_decode_axpy(a, bits, w, out=a)),
                "plain_ms": chunk_ms(lambda a, bits: mc.decode_axpy_plain(a, bits, w)),
                "library_ms": chunk_ms(lambda a, bits: torch.add(a, bits.view(torch.bfloat16), alpha=w)),
                # One launch with its host call, as the first design's folder made 16 a flush.
                "single_launch_ms": time_cold_ms(
                    lambda i: mc.bf16_decode_axpy(views[i][0], views[i][1], w, out=views[i][0]), sets),
                "library_call": "torch.add(acc, bits.view(torch.bfloat16), alpha=w)",
                "bytes": cb, "flops": cf, "bound_ms": max(cb / mem_rate, cf / f32_rate) * 1e3,
                "bound_by": "bytes" if cb / mem_rate >= cf / f32_rate else "operations",
            }
            row["K5"] = {"chunk": chunk, "whole_buffer": whole}
            del scratch, views, cycle
            # One encode as the averager calls it: numpy in, numpy out.
            codec = mc.MeshCodec(device="cuda")
            host = x.cpu().numpy()
            codec.encode_bf16(host)
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = codec.encode_bf16(host)
                walls.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(out, bits_p.cpu().numpy().view(np.uint16)):
                raise AssertionError("MeshCodec.encode_bf16 differs from the plain encode")
            row["encode_bf16_wall_ms"] = statistics.median(walls)
            row["encode_bf16_wall_ms_all"] = walls
            # The flat K5 as the codec's own entry point calls it.
            got = codec.decode_axpy(acc.cpu().numpy(), bits_p.cpu().numpy().view(np.uint16), w)
            eq = bits_equal(torch.from_numpy(got).cuda(), fold_k)
            if eq["finite_lanes_differing"] or not eq["nonfinite_match"]:
                raise AssertionError(f"MeshCodec.decode_axpy differs from bf16_decode_axpy: {eq}")
            results = row
        emit(row)
        del x, acc, bits_k, bits_p, fold_k, fold_p
    torch.cuda.empty_cache()
    results["K5"]["flush"] = fold_phase(mem_rate, f32_rate)
    torch.cuda.empty_cache()
    return results


def codec_flushes(kind: str, gen: torch.Generator, rng, sets: int = FLUSH_SETS) -> dict:
    """``sets`` staged flushes of gpt2_small's flat buffer as the folder
    stages them, over disjoint tiles, each with its own bits (a short tail
    chunk zero-padded), and the accumulator [n_tiles, tile] they fold into.
    ``flagship``: 16 chunks of 1 MiB (12 tiles, the short tail tile, three
    repeats; one zero weight). ``small``: 256 chunks of 64 KiB (a transport's
    ``chunk_bytes`` of 1 << 16), every tile distinct."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc

    tile = CHUNK_N if kind == "flagship" else 1 << 15
    n_tiles = -(-FLAT_N // tile)
    tail = FLAT_N - (n_tiles - 1) * tile
    order = rng.permutation(n_tiles - 1)
    out = []
    for s in range(sets):
        if kind == "flagship":
            ts = order[12 * s : 12 * (s + 1)].tolist() + [n_tiles - 1]
            ts = ts + ts[:3]
        else:
            ts = order[256 * s : 256 * (s + 1)].tolist()
        k = len(ts)
        ws = rng.uniform(0.25, 2.0, k).astype(np.float32).tolist()
        ws[5] = 0.0
        lens = [tail if t == n_tiles - 1 else tile for t in ts]
        bits = mc.encode_bf16_plain(torch.randn(k * tile, generator=gen, device="cuda")).view(k, tile)
        for i, n in enumerate(lens):
            bits[i, n:] = 0
        cols = {t: n for t, n in zip(ts, lens)}
        out.append({
            "tiles": ts, "weights": ws, "lens": lens, "bits": bits,
            # The library yardstick's input: the weighted decoded batch.
            "dec": torch.tensor(ws, device="cuda")[:, None] * mc.widen_bf16(bits),
            "tiles_t": torch.tensor(ts, device="cuda"),
            # Bits read once, every touched accumulator element read and written once.
            "bytes": 2 * sum(lens) + 8 * sum(cols.values()), "flops": 2 * sum(lens),
        })
    acc = torch.randn((n_tiles, tile), generator=gen, device="cuda")
    return {"kind": kind, "tile": tile, "n_tiles": n_tiles, "sets": out, "acc": acc}


def k5_launch_range(tiles, lens) -> tuple:
    """The fewest and most K5 launches a batch's chunk table may take, from
    its word count alone: W = 3·U + 3·K for U distinct tiles and K chunks of
    non-zero length, one more word per launch, at most ``K5_FOLD_WORDS`` a
    launch. Every launch but the last stopped short of a tile that needs at
    most 3 + 3·c words (c its most chunks of one tile)."""
    counts = collections.Counter(t for t, n in zip(tiles, lens) if n > 0)
    words = 3 * len(counts) + 3 * sum(counts.values())
    if words + 1 <= K5_FOLD_WORDS:
        return 1, 1
    return -(-words // (K5_FOLD_WORDS - 1)), 1 + words // (K5_FOLD_WORDS - 4 - 3 * max(counts.values()))


def fold_phase(mem_rate: float, f32_rate: float) -> dict:
    """K5 as the folder calls it: ``bf16_fold_chunks`` against
    ``fold_chunks_plain`` on four staged flushes (see the module doc),
    bit-equal on finite lanes with inf and NaN lanes matching, and its
    launches within ``k5_launch_range``; then per flagship flush (cycling
    over ``FLUSH_SETS`` flushes) the wrapper's time (host table and launch
    included), the kernel's device time from the profiler, the plain
    version's, one ``index_add_`` of the decoded batch, and the bound."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc

    gen = torch.Generator(device="cuda").manual_seed(5150)
    rng = np.random.default_rng(5150)
    flag = codec_flushes("flagship", gen, rng)
    f0 = flag["sets"][0]
    # ragged: nd = 2 ranks of 4101 columns, each reading whole rows from its
    # own column (rank 1 at an odd offset), the tail tile shorter than one shard.
    r_tile, r_n = 2 * 4101, 3 * 2 * 4101 + 3000
    r_tiles = [0, 3, 1, 3, 2, 0, 3]
    r_lens = [min(r_tile, r_n - t * r_tile) for t in r_tiles]
    r_bits = mc.encode_bf16_plain(torch.randn(len(r_tiles) * r_tile, generator=gen, device="cuda"))
    r_bits = r_bits.view(len(r_tiles), r_tile)
    # special: random bit patterns (subnormals, inf, NaN) with the special
    # values up front in every chunk.
    sp_bits = torch.randint(-(2**15), 2**15, (6, 65536), generator=gen, device="cuda", dtype=torch.int32)
    sp_bits = sp_bits.to(torch.int16)
    sp_bits[:, : len(RING_SPECIAL_BF16)] = torch.from_numpy(
        np.array(RING_SPECIAL_BF16, np.uint16).view(np.int16)).cuda()
    # split: 600 chunks of 1024 over 300 tiles, more table than one launch holds.
    s_tiles = rng.permutation(np.repeat(np.arange(300), 2)).tolist()
    s_lens = [1019 if t == 299 else 1024 for t in s_tiles]
    r_weights = [1.5, 0.0, 0.75, 2.0, 0.5, 1.25, 1.0]
    cases = [
        ("flagship", flag["acc"], [(f0["bits"], f0["tiles"], f0["weights"], f0["lens"], 0, slice(None))]),
        ("ragged", torch.randn((4, r_tile), generator=gen, device="cuda"), [
            (r_bits, r_tiles, r_weights,
             [min(max(n - r * 4101, 0), 4101) for n in r_lens], r * 4101, slice(r * 4101, (r + 1) * 4101))
            for r in range(2)]),
        ("special", torch.randn((3, 65536), generator=gen, device="cuda"),
         [(sp_bits, [0, 1, 2, 1, 0, 2], [1.0, 0.0, 2.5, 0.5, 1.5, 3.0], [65536] * 6, 0, slice(None))]),
        ("split", torch.randn((300, 1024), generator=gen, device="cuda"), [
            (mc.encode_bf16_plain(torch.randn(600 * 1024, generator=gen, device="cuda")).view(600, 1024),
             s_tiles, rng.uniform(0.5, 2.0, 600).tolist(), s_lens, 0, slice(None))]),
    ]
    out = {"cases": []}
    for name, acc0, ranks in cases:
        row = {"phase": "codec_fold", "case": name, "ranks": len(ranks), "ranks_vs_plain": []}
        ok = True
        for bits, tiles, weights, lens, col0, cols in ranks:
            acc_k = acc0[:, cols].clone(memory_format=torch.contiguous_format)
            acc_p = acc0[:, cols].clone(memory_format=torch.contiguous_format)
            before = mc.LAUNCHES["bf16_fold_chunks"]
            made = mc.bf16_fold_chunks(acc_k, bits, tiles, weights, lens, col0)
            launched = mc.LAUNCHES["bf16_fold_chunks"] - before
            mc.fold_chunks_plain(acc_p, bits, tiles, weights, lens, col0)
            torch.cuda.synchronize()
            eq = bits_equal(acc_k, acc_p)
            lo, hi = k5_launch_range(tiles, lens)
            eq.update(chunks=len(tiles), distinct_tiles=len(set(tiles)), shard=acc_k.shape[1], col0=col0,
                      launches=launched, launches_expected=[lo, hi])
            row["ranks_vs_plain"].append(eq)
            ok = ok and eq["finite_lanes_differing"] == 0 and eq["nonfinite_match"]
            ok = ok and made == launched and lo <= launched <= hi and (name != "split" or launched >= 2)
            del acc_k, acc_p
        row["ok"] = bool(ok)
        emit(row)
        if not ok:
            raise AssertionError(f"K5 (bf16_fold_chunks) disagrees with fold_chunks_plain ({name})")
        out["cases"].append(row)

    acc, sets = flag["acc"], flag["sets"]
    cycle = itertools.cycle(sets)

    def fold():
        f = next(cycle)
        mc.bf16_fold_chunks(acc, f["bits"], f["tiles"], f["weights"], f["lens"], 0)

    def plain():
        f = next(cycle)
        mc.fold_chunks_plain(acc, f["bits"], f["tiles"], f["weights"], f["lens"], 0)

    def library():
        f = next(cycle)
        acc.index_add_(0, f["tiles_t"], f["dec"])

    nbytes, flops = f0["bytes"], f0["flops"]
    out["timing"] = {
        "chunks": len(f0["tiles"]), "distinct_tiles": len(set(f0["tiles"])),
        "launches_per_flush": 1,
        "device_ms_profiler": kernel_device_ms(fold, "bf16_fold_kernel", iters=4 * FLUSH_SETS),
        "device_ms_spin": device_ms(fold, reps=4 * FLUSH_SETS)["ms"],
        "wrapper_ms": time_ms(fold, iters=8 * FLUSH_SETS),
        "plain_ms": time_ms(plain, iters=2 * FLUSH_SETS),
        "library_ms": time_ms(library, iters=8 * FLUSH_SETS),
        "library_call": "acc.index_add_(0, tiles, w * widen(bits)) of the flush's batch, decode not timed",
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(nbytes / mem_rate, flops / f32_rate) * 1e3,
        "bound_by": "bytes" if nbytes / mem_rate >= flops / f32_rate else "operations",
        "max_abs_err": max(r["max_abs_err"] for c in out["cases"] for r in c["ranks_vs_plain"]),
    }
    out["timing"]["device_ms"] = out["timing"]["device_ms_profiler"]["ms"]
    emit({"phase": "codec_fold", "timing": out["timing"]})
    del flag, cases, sets, acc
    return out


# ---------------------------------------------------------------------------
# averaging: two full-width volunteers, sync rounds on the bf16 wire
# ---------------------------------------------------------------------------

AVG_COMMITS = 3  # committed rounds after which each volunteer stops: round 1 parks dense, later ones stream
AVG_MAX_STEPS = 400  # cap on each trainer's steps, far above what 3 commits take
AVG_EVERY = 2
# Blocking rounds. With overlap, the two trainers drift apart (the leader's
# host also folds, so it steps more slowly) and nothing brings them
# back into phase: a member still fetching parks the leader's next begin
# past its 3 s TTL, both then lead lone rounds that wait out the gather
# deadline, and one full-width run committed 2 of 11 rounds. Blocking
# rounds meet at each cadence step. The overlapped merge is held to the
# reference's on the CPU (tests/test_torch_trainer_avg.py).
AVG_OVERLAP = False


def expected_codec_launches(
    groups_formed: int, committed_rounds: int, folder_flushes: int,
    nd: int = 1, ring: bool = False, ring_flushes: int = 0, ring_results: int = 0, cards: int = 1,
) -> dict:
    """Launches the round protocol implies for two volunteers sharing the
    card (``swarm/averager.py``, ``swarm/agg_stream.py``, health probe on),
    from what is known without the codec: the groups matchmaking formed
    (counted where ``_form_group`` returns) and the rounds that committed.

    K4: every round whose group formed packs its contribution once (a round
    that forms no group returns before the pack; a group can hold one
    volunteer alone, whose round is then skipped at the gather deadline),
    and each pack encodes
    twice — the 64 Ki-slice health probe (``_note_codec_distortion``) and the
    whole buffer: the leader's own contribution as peers see it
    (``_wire_roundtrip``), or the member's push (``_wire_stream``, one
    whole-buffer encode on an active codec). Each committed round of two has
    one member, whose fetch the leader encodes once (``_wire_stream`` of
    ``st.result``); a skipped round has no result to encode. A codec of
    ``nd`` ranks launches K4 once per rank for each encode.
    K5: one per rank per flush of the leader's staged folder
    (``MeshMeanFolder._flush_dev`` folds a whole staged batch in one launch;
    a flush of at most 16 chunks of 1 MiB, 97 table words, always fits one),
    counted by the aggregators' ``folder_flushes`` gauge (about 15 flushes
    per streamed contribution of gpt2_small's 249 MB); none under the ring.
    Round 1 parks the member's push dense (the leader arms after its first
    pack); dense feeds are plain ``add_``.
    K6 / K7 (ring, ``nd`` ranks in ``cards`` K6 launch groups,
    ``k6_launch_groups``), counted by the codec's ``ring_flushes`` and
    ``ring_results`` gauges; a flagship flush of 1 MiB chunks always fits one
    ring's metadata. One card holding every rank: one K6 launch per ring
    flush and one K7 launch per ring result. Across cards: nd steps of one
    K6 launch per card per flush, nd - 1 hops of nd K7 launches per result."""
    out = {
        "bf16_encode": nd * (2 * groups_formed + committed_rounds),
        "bf16_fold_chunks": 0 if ring else nd * folder_flushes,
    }
    if ring and cards == 1:
        out.update(ring_fold=ring_flushes, ring_allgather=ring_results)
    elif ring:
        out.update(ring_fold=nd * cards * ring_flushes, ring_allgather=nd * (nd - 1) * ring_results)
    return out


class ProtoRecorder:
    """Wraps an in-process volunteer's averager callback and its group
    formation. Per averaging call: the group it formed (epoch, size, member
    ids, and the schedule's group id and level when a group schedule
    assigned it), the contribution's weight, the outcome (partners on time and absent,
    degraded) and the seconds; with ``keep``, the flat payload and result of
    the last ``keep`` calls that returned a result. The weight is the
    samples behind the contribution as the recorder counts them: the batch
    times the steps since the last call that returned a result (since the
    trainer's step at wrapping time before the first), so a fault in the
    trainer's own count shows in the value checks. ``groups`` counts the
    groups formed. ``before`` and ``after(call, result)`` run around each
    call; once ``done(recorder)`` holds, ``stop_all`` runs (by default it
    stops this volunteer after its current step)."""

    def __init__(self, vol, keep: int = 2):
        from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

        self.vol, self.calls, self.groups = vol, [], 0
        self.buffers = collections.deque(maxlen=keep)
        self.group = self.outcome = self.last_params = None
        self.members, self.assignment = [], None
        self.last_merge = int(vol.trainer.state.step)
        self.before = lambda: None
        self.after = lambda call, result: None
        self.done = lambda rec: False
        self.stop_all = vol._stop.set
        avg = vol.averager
        inner, form_group, flush = vol._averager_callback, avg._form_group, avg._flush_round_outcome

        async def counted_form_group(round_key):
            group = await form_group(round_key)
            self.group = (group.epoch, len(group.members)) if group is not None else None
            self.members = [pid for pid, _ in group.members] if group is not None else []
            self.assignment = avg._last_group if avg.group_schedule is not None else None
            self.groups += group is not None
            return group

        def recording_flush(duration_s, ok):
            # The round's outcome, which the flush to the policy clears.
            self.outcome = (dict(avg._last_outcomes or {}), bool(getattr(avg, "_round_degraded", False)))
            return flush(duration_s, ok)

        def cb(params, step):
            if vol._stop.is_set():
                return None
            self.group = self.outcome = self.assignment = None
            self.members, self.last_params = [], params
            self.before()
            weight = vol.cfg.batch_size * max(1, step - self.last_merge)
            t0 = time.perf_counter()
            result = inner(params, step)
            outcomes, degraded = self.outcome or ({}, False)
            call = {
                "step": step, "weight": weight, "s": time.perf_counter() - t0, "ok": result is not None,
                "epoch": self.group[0] if self.group else None, "size": self.group[1] if self.group else 0,
                "members": self.members, "outcomes": outcomes, "degraded": degraded,
                "group_id": self.assignment.group_id if self.assignment else None,
                "level": self.assignment.level if self.assignment else None,
            }
            if result is not None:
                self.last_merge = step
            self.calls.append(call)
            self.after(call, result)
            if result is not None and keep:
                self.buffers.append({**call, "payload": flatten_to_buffer(params)[0],
                                     "result": flatten_to_buffer(result)[0]})
            if self.done(self):
                self.stop_all()
            return result

        avg._form_group, avg._flush_round_outcome = counted_form_group, recording_flush
        vol.trainer.averager = cb

    def committed(self) -> int:
        return sum(c["ok"] for c in self.calls)

    def full_rounds(self, size: int, partners: int) -> list:
        """Committed calls in a group of ``size`` that mixed with
        ``partners`` partners on time and missed none."""
        return [c for c in self.calls if c["ok"] and c["size"] == size and not c["degraded"]
                and len(c["outcomes"].get("on_time", ())) == partners and not c["outcomes"].get("absent")]


def averaging_phase(mesh=None, collective: str = "auto", phase: str = "averaging", model: str = "gpt2_small",
                    batch_size: int = 8, every: int = AVG_EVERY, lr=None, extra=None, commits=AVG_COMMITS,
                    max_steps: int = AVG_MAX_STEPS, keep: int = 2, hooks=None, all_rounds: bool = False,
                    check_flash: bool = False, overrides=None) -> dict:
    """Two full-width volunteers averaging in blocking sync rounds (see the
    module doc): gpt2_small at batch 8 every ``AVG_EVERY`` steps by
    default. With ``mesh`` (a port ``Mesh``) each volunteer trains
    data-parallel over its ranks and its codec runs on them; ``collective``
    "ring" folds the leader's rounds on K6/K7. ``extra`` adds config fields
    (``average_what``, ``data_path``, the outer optimizer); ``commits=None``
    trains ``max_steps`` steps instead of stopping on a count of committed
    rounds; each recorder keeps the payload and result of its last ``keep``
    committed calls; ``hooks`` (``setup(vols, recs)`` before training,
    ``finish(vols, recs, failures) -> dict`` after it, before the volunteers
    stop) add a phase's own checks; ``all_rounds`` checks the values of
    every round both recorded, not one streamed round; ``check_flash``
    holds K1-K3 to their launches per step of the steps trained and returns
    their counts too; ``overrides`` are the model's registry overrides
    (``DEPTH_CUT``: fewer layers, every width kept)."""
    from distributedvolunteercomputing_tpu_torch import native
    from distributedvolunteercomputing_tpu_torch.ops import mesh_collective as mcol
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig

    if not native.ensure_built():
        raise RuntimeError("the host codec's C++ core did not build")
    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)

    def recording(vol):
        """Once ``AVG_COMMITS`` rounds have committed, the volunteer stops
        after its current step and launches no more rounds. Every committed
        round has both volunteers in it, so the k-th committed round of one
        is the k-th of the other; each call also records whether this
        volunteer led a streamed round."""
        rec = ProtoRecorder(vol, keep=keep)
        gauges = vol.averager._agg_gauges
        streamed_before = [0]

        def before():
            streamed_before[0] = gauges.get("streamed_contribs", 0)

        def after(call, result):
            call["round"] = rec.committed()
            call["led_streamed"] = gauges.get("streamed_contribs", 0) > streamed_before[0]

        rec.before, rec.after = before, after
        rec.done = (lambda r: r.committed() >= commits) if commits else (lambda r: False)
        return rec

    async def run_pair():
        base = dict(model=model, batch_size=batch_size, averaging="sync", wire="bf16",
                    average_every=every, overlap=AVG_OVERLAP, steps=max_steps,
                    mesh=mesh if mesh is not None else "", mesh_collective=collective,
                    model_overrides=dict(overrides or {}),
                    **({"lr": lr} if lr is not None else {}), **(extra or {}))
        paths = [out_dir / f"{phase}_volunteer{i}.jsonl" for i in range(2)]
        for p in paths:
            p.unlink(missing_ok=True)
        release_card_memory()
        t0 = time.perf_counter()
        v0 = Volunteer(VolunteerConfig(peer_id="vol0", seed=1, metrics_path=str(paths[0]), **base))
        await v0.start()
        v1 = Volunteer(VolunteerConfig(peer_id="vol1", seed=2, metrics_path=str(paths[1]),
                                       coordinator="%s:%d" % v0.transport.addr, **base))
        await v1.start()
        start_s = time.perf_counter() - t0
        recs = [recording(v0), recording(v1)]
        if hooks is not None:
            hooks.setup((v0, v1), recs)
        torch.cuda.synchronize()
        reset_all_launch_counts()
        t0 = time.perf_counter()
        try:
            # Both leave only after both have trained: a leader that leaves
            # at once would strand the member's fetch of the last round.
            # stop() alone ends membership; the round cap only ends training.
            summaries = await asyncio.gather(v0.train(), v1.train())
            torch.cuda.synchronize()
            launches = {**dict(mc.LAUNCHES), **dict(mcol.LAUNCHES), **flash_launches()}
            run_s = time.perf_counter() - t0
            own = hooks.finish((v0, v1), recs, hook_failures) if hooks is not None else {}
        finally:
            await asyncio.gather(v0.stop(), v1.stop())
        return summaries, launches, start_s, run_s, paths, recs, own

    hook_failures: list = []
    summaries, launches, start_s, run_s, paths, recs, own = asyncio.run(run_pair())
    round_launches = [len(r.calls) for r in recs]
    groups_formed = [r.groups for r in recs]
    committed = [r.committed() for r in recs]
    events = [[json.loads(line) for line in p.read_text().splitlines()] for p in paths]
    losses = [[e["loss"] for e in ev if "loss" in e] for ev in events]
    rounds_s = [[e.get("avg_s") for e in ev if e.get("event") == "avg_round" and e.get("ok")] for ev in events]
    agg = [s.get("aggregation", {}) for s in summaries]
    codec_stats = summaries[0]["mesh_codec"]
    rounds = [s["rounds_ok"] for s in summaries]
    streamed = sum(a.get("streamed_contribs", 0) for a in agg)
    spans = [s["telemetry"]["spans"] for s in summaries]
    packs = sum(sp.get("encode", {}).get("count", 0) for sp in spans)
    fetches = sum(sp.get("fetch", {}).get("count", 0) for sp in spans)
    nd = codec_stats["devices"]
    ring = collective == "ring"
    cards = k6_launch_groups(mesh.flat()) if mesh is not None else 1
    folder_flushes = sum(a.get("folder_flushes", 0) for a in agg)
    expect = expected_codec_launches(
        sum(groups_formed), rounds[0], folder_flushes, nd=nd, ring=ring,
        ring_flushes=codec_stats["ring_flushes"], ring_results=codec_stats["ring_results"], cards=cards,
    )
    folder = "ring" if ring else "staged"
    row = {
        "phase": phase, "model": model, "overrides": overrides, "batch_size": batch_size, "lr": lr,
        "max_steps": max_steps,
        "extra": {k: (v if k != "data_path" else Path(v).name) for k, v in (extra or {}).items()},
        "mesh": repr(mesh) if mesh is not None else None, "collective": collective,
        "commits": commits, "steps": [s["steps"] for s in summaries],
        "average_every": every, "overlap": AVG_OVERLAP, "wire": "bf16",
        "params": int(recs[0].buffers[-1]["payload"].size) if recs[0].buffers else None,
        "start_s": start_s, "run_s": run_s, "rounds_ok": rounds,
        "rounds_skipped": [s["rounds_skipped"] for s in summaries],
        "rounds_degraded": [s["rounds_degraded"] for s in summaries],
        "round_s": rounds_s, "losses": losses, "final_loss": [s["final_loss"] for s in summaries],
        "aggregation": agg, "mesh_codec": codec_stats, "hedge": [s.get("hedge") for s in summaries],
        "wan_bytes_sent": [s["wan_bytes_sent"] for s in summaries],
        "round_launches": round_launches, "groups_formed": groups_formed, "packs": packs, "fetches": fetches,
        "streamed_contribs": streamed, "folder_flushes": folder_flushes,
        "k5_launches_per_streamed_contrib": launches["bf16_fold_chunks"] / max(1, streamed),
        "spans": spans,  # per volunteer: round phases (join, encode, wire, fold, commit, fetch), count and seconds
        "launches": launches, "codec_launches_expected": expect,
        "codec_launches_per_committed_round": {k: launches[k] / max(1, rounds[0]) for k in expect},
    }
    failures = list(hook_failures)
    # A skipped round is allowed (reported): a volunteer that forms no group,
    # or forms one alone, skips it. Committed rounds count on both.
    if min(rounds) < 2 or rounds[0] != rounds[1] or any(row["rounds_degraded"]):
        failures.append(f"rounds ok {rounds}, skipped {row['rounds_skipped']}, degraded {row['rounds_degraded']}")
    if committed != rounds:
        failures.append(f"results returned to the trainers {committed} != rounds committed {rounds}")
    if streamed < 1 or not any(a.get("folder_kind") == folder and a.get("folder_flushes", 0) > 0 for a in agg):
        failures.append(f"no contribution streamed through the leader's {folder} device folder")
    if ring and sum(a.get("ring_flushes", 0) for a in agg) != codec_stats["ring_flushes"]:
        failures.append(f"ring flushes: aggregators {[a.get('ring_flushes') for a in agg]}, codec {codec_stats}")
    if sum(a.get("aborted_contribs", 0) + a.get("tiles_recovered", 0) + a.get("hedge_duplicates", 0)
           for a in agg):
        failures.append("aborted or hedged contributions: the launch counts below would not be exact")
    if codec_stats["backend"] != "device" or codec_stats["ops_host"] != 0:
        failures.append(f"codec not on the device path: {codec_stats}")
    if packs != sum(groups_formed):
        failures.append(f"{packs} packs (encode spans) != {groups_formed} groups formed")
    if {k: launches[k] for k in expect} != expect:
        failures.append(f"codec launches {[launches[k] for k in expect]} != expected {expect}")
    if not all(losses) or not all(math.isfinite(x) for ls in losses for x in ls):
        failures.append("missing or non-finite losses")
    if check_flash:
        per_step = flash_per_step(model, overrides)
        row["flash_expected"] = {k: n * sum(s["steps"] for s in summaries) for k, n in zip(KERNELS, per_step)}
        if {k: launches[k] for k in KERNELS} != row["flash_expected"]:
            failures.append(f"K1-K3 launches {[launches[k] for k in KERNELS]} != {row['flash_expected']}")
    row["values"] = check_averaged_values([r.buffers for r in recs], failures, all_rounds=all_rounds)
    row.update(own)
    emit(row)
    if failures:
        raise AssertionError(f"{phase} phase: {failures}")
    if check_flash:
        return {k: launches[k] for k in (*expect, *KERNELS)}
    return {k: launches[k] for k in expect}


def check_averaged_values(records, failures, all_rounds: bool = False, nearest_leads: bool = False) -> dict:
    """One streamed round: the leader's result against the f64 weighted mean
    of the two payloads, the member's against the leader's (``AVG_TOL``).
    With ``all_rounds``, every round both recorded, streamed or not: its
    leader is the volunteer whose result is nearer the weighted mean (a
    dense round has no streamed gauge to name it). The arithmetic is f64,
    on the card."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"

    def f64(a):
        return torch.from_numpy(a).to(dev, torch.float64)

    by_round = [{r["round"]: r for r in rec} for rec in records]
    common = sorted(set(by_round[0]) & set(by_round[1]), reverse=True)
    if all_rounds:
        rows = []
        for rnd in sorted(common):
            row = check_averaged_values([[by_round[0][rnd]], [by_round[1][rnd]]], failures, nearest_leads=True)
            rows.append(row)
        if len(rows) < 2:
            failures.append(f"values of {len(rows)} rounds recorded on both volunteers, want >= 2")
        return {"rounds": rows}
    for rnd in common:
        pair = (by_round[0][rnd], by_round[1][rnd])
        leaders = [i for i, r in enumerate(pair) if r["led_streamed"]]
        if not leaders and not nearest_leads:
            continue
        x0, x1 = f64(pair[0]["payload"]), f64(pair[1]["payload"])
        w0, w1 = pair[0]["weight"], pair[1]["weight"]
        want = (w0 * x0 + w1 * x1) / (w0 + w1)
        results = [f64(p["result"]) for p in pair]
        if not leaders:
            leaders = [min((0, 1), key=lambda i: (results[i] - want).abs().max().item())]
        lead_r, memb_r = results[leaders[0]], results[1 - leaders[0]]
        scale = torch.maximum(x0.abs(), x1.abs())
        tol = AVG_TOL
        lim = (tol["bf16_u"] + tol["f32_ulps"]) * scale + tol["floor"]
        err = (lead_r - want).abs()
        lim_m = tol["bf16_u"] * lead_r.abs() + tol["f32_ulps"] * lead_r.abs() + tol["floor"]
        err_m = (memb_r - lead_r).abs()
        out = {
            "round": rnd, "step": pair[leaders[0]]["step"], "weights": [w0, w1], "n": int(x0.numel()),
            "leader": leaders[0], "leader_limit_used": (err / lim).max().item(),
            "leader_max_abs_err": err.max().item(), "member_limit_used": (err_m / lim_m).max().item(),
            "member_max_abs_err": err_m.max().item(), "tol": tol,
            "finite": bool(torch.isfinite(lead_r).all() and torch.isfinite(memb_r).all()),
        }
        del x0, x1, want, results, lead_r, memb_r, scale, lim, err, lim_m, err_m
        if not (out["finite"] and out["leader_limit_used"] <= 1.0 and out["member_limit_used"] <= 1.0):
            failures.append(f"averaged values outside AVG_TOL: {out}")
        return out
    failures.append("no streamed round with both results recorded")
    return {}


def group_values(group: dict, leader: str, failures: list) -> dict:
    """One committed round of a group of any size: ``group`` maps each member
    to its record (weight, payload, result). The leader's result against the
    f64 weighted mean of every member's payload, each member's against the
    leader's (``AVG_TOL``, as ``check_averaged_values``); f64 on the card."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    tol = AVG_TOL
    xs = {pid: torch.from_numpy(r["payload"]).to(dev, torch.float64) for pid, r in group.items()}
    ws = {pid: r["weight"] for pid, r in group.items()}
    want = sum(ws[p] * xs[p] for p in xs) / sum(ws.values())
    scale = torch.stack(list(xs.values())).abs().amax(0)
    del xs
    lead = torch.from_numpy(group[leader]["result"]).to(dev, torch.float64)
    err = (lead - want).abs()
    out = {"members": list(group), "leader": leader, "weights": ws, "step": group[leader]["step"],
           "leader_max_abs_err": err.max().item(),
           "leader_limit_used": (err / ((tol["bf16_u"] + tol["f32_ulps"]) * scale + tol["floor"])).max().item(),
           "member_limit_used": 0.0, "finite": bool(torch.isfinite(lead).all())}
    del want, scale, err
    lim = (tol["bf16_u"] + tol["f32_ulps"]) * lead.abs() + tol["floor"]
    for pid, r in group.items():
        if pid != leader:
            got = torch.from_numpy(r["result"]).to(dev, torch.float64)
            out["member_limit_used"] = max(out["member_limit_used"], ((got - lead).abs() / lim).max().item())
            out["finite"] &= bool(torch.isfinite(got).all())
            del got
    del lead, lim
    if not (out["finite"] and out["leader_limit_used"] <= 1.0 and out["member_limit_used"] <= 1.0):
        failures.append(f"averaged values outside AVG_TOL: {out}")
    return out


# ---------------------------------------------------------------------------
# the trainer's modes: multi-step calls, eval, gradient rounds, the outer
# Nesterov step, .npz data (capability configs 6 and 7)
# ---------------------------------------------------------------------------

MULTI_STEPS = 8  # steps of each run of multi_step
MULTI_SPC = 4  # steps_per_call of the chunked run: two chunks of 4
EVAL_BATCHES = 2  # held-out batches of the eval check (K1 only, 12 a batch)
# Chunked against single steps on the card: the same ops in the same order,
# so bit-equal is expected; the limits are the dp phase's for the loss and
# each param leaf's update (PARITY_TOL["dp"]'s reasoning: Adam turns a
# rounding difference of a near-zero gradient into up to ~lr), in case a
# reduction on the card (cuBLAS, the embedding backward) is not deterministic.
PARITY_TOL["multi"] = {"loss": 1e-6, "update_l2": 1e-3}
# Eval through the kernels against the plain attention core on one batch,
# bf16 on the card: the trainer parity's bf16 loss limit.
PARITY_TOL["eval"] = {"loss": PARITY_TOL["bf16"]["loss"]}
GRAD_STEPS = 4  # steps of each grad_averaging volunteer: a gradient round every step
# grad_averaging: both volunteers start from one init and, at every step
# whose round committed on both, apply the same round result: the leader its
# f32 mean, the member that mean through the bf16 wire, each element within
# bf16_u of the leader's. The global-norm clip scales both by norms within
# bf16_u of each other, so the two applied gradients differ elementwise by a
# relative GRAD_EPS = 2 bf16_u + bf16_u^2. Adam's update lr * m_hat /
# (sqrt(v_hat) + eps) then differs per element and step by at most
# lr_t * 2 GRAD_EPS / (1 - GRAD_EPS) * sqrt(c2) / c1 * sqrt(sum_k w_k^2 / z_k)
# (Cauchy-Schwarz on the moment sums, w_k = (1 - b1) b1^(t-k), z_k = (1 - b2)
# b2^(t-k), c1 = 1 - b1^t, c2 = 1 - b2^t; the gain is 1.00-1.01 for t <= 8),
# summed over the steps (``adam_drift_bound``), plus one f32 rounding of
# each side's add per step (2 * 2^-24 * |p|). A step whose round did not
# commit on both applies different local gradients: the bound then does
# not hold, and the phase requires every round to commit.
GRAD_EPS = 2 * AVG_TOL["bf16_u"] + AVG_TOL["bf16_u"] ** 2
OUTER = dict(outer_optimizer="nesterov", outer_lr=0.7, outer_momentum=0.9)  # the reference's defaults
OUTER_COMMITS = 3  # committed rounds of each outer_sync volunteer: round 1 adopts, 2 and 3 take the Nesterov step
# Capability configs 6 and 7 (experiments/run_matrix.py config6_file_mnist,
# config7_file_resnet): the files come from experiments/make_npz.py.
# ``--target-mode record`` is added to config 6's flags: with "stop" the run
# ends at the crossing (step ~3), before its first eval point at 50, and the
# eval stream would never run on the card.
MNIST_FILE_ARGV = ["--model", "mnist_mlp", "--averaging", "none", "--steps", "300", "--batch-size", "32",
                   "--lr", "0.01", "--target-loss", "0.15", "--eval-every", "50", "--eval-batches", "4",
                   "--target-mode", "record"]


def adam_drift_bound(lrs, b1: float, b2: float, rel: float) -> float:
    """The largest difference two Adam runs can reach per element after
    len(lrs) steps whose gradients differ elementwise by at most ``rel``
    relative (see ``GRAD_EPS``)."""
    total = 0.0
    for t, lr in enumerate(lrs, start=1):
        c1, c2 = 1 - b1**t, 1 - b2**t
        ratio = sum(((1 - b1) * b1**j) ** 2 / ((1 - b2) * b2**j) for j in range(t))
        total += lr * 2 * rel / (1 - rel) * math.sqrt(c2) / c1 * math.sqrt(ratio)
    return total


def make_npz(task: str, out_dir: Path) -> Path:
    """A capability config's data file, written by ``experiments/make_npz.py``."""
    path = out_dir / f"data_{task}.npz"
    subprocess.run([sys.executable, str(HERE / "experiments" / "make_npz.py"), "--task", task, "--out", str(path)],
                   check=True, capture_output=True, text=True, timeout=120)
    return path


def multi_step_phase(fa) -> dict:
    """gpt2_small at full width, batch 8: ``MULTI_STEPS`` single steps, then
    the same from the same init on the same batches at ``steps_per_call``
    ``MULTI_SPC``, each as two runs of half the steps (samples/s of the
    second). Losses and every param leaf against the single steps
    (``PARITY_TOL["multi"]``, bit-equality reported), K1-K3 24 / 12 / 12 a
    step in each. Then eval on the chunked run's
    params: ``evaluate`` of ``EVAL_BATCHES`` held-out batches launches K1
    12 times a batch under no_grad and nothing else, and one batch's eval
    loss through the kernels agrees with the plain core's."""
    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.ops.attention import set_attention_impl
    from distributedvolunteercomputing_tpu_torch.training.steps import make_eval_step
    from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
    from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

    bundle = get_model("gpt2_small")
    gen = torch.Generator().manual_seed(11)
    batches = [bundle.make_batch(gen, 8) for _ in range(MULTI_STEPS)]
    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs, p0, trainer, names = {}, None, None, None
    failures = []
    for spc in (1, MULTI_SPC):
        path = out_dir / f"multi_step_spc{spc}.jsonl"
        path.unlink(missing_ok=True)
        trainer = None
        release_card_memory()
        trainer = Trainer(bundle, batch_size=8, steps_per_call=spc, total_steps=MULTI_STEPS,
                          data=iter(batches), metrics_path=str(path))
        leaves = tree_leaves(trainer.state.params)
        if p0 is None:
            p0 = [x.detach().clone() for x in leaves]
            names = leaf_names(trainer.state.params)
        elif not all(torch.equal(a, b) for a, b in zip(leaves, p0)):
            failures.append("the two runs did not start from the same init")
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        # The first half warms the process up; samples/s is the second's.
        trainer.run(steps=MULTI_STEPS // 2, log_every=0)
        torch.cuda.synchronize()
        summary = trainer.run(steps=MULTI_STEPS - MULTI_STEPS // 2, log_every=0)
        torch.cuda.synchronize()
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        runs[spc] = {"summary": summary, "launches": dict(fa.LAUNCHES),
                     "losses": [r["loss"] for r in recs if "loss" in r],
                     "params": [x.detach().clone() for x in tree_leaves(trainer.state.params)]}
    single, multi = runs[1], runs[MULTI_SPC]
    expect = {"flash_fwd": 24 * MULTI_STEPS, "flash_dq": 12 * MULTI_STEPS, "flash_dkv": 12 * MULTI_STEPS}
    tol = PARITY_TOL["multi"]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(multi["losses"], single["losses"]))
    leaves = {}
    for name, a, b, init in zip(names, multi["params"], single["params"], p0):
        upd = (b.float() - init.float()).norm().item()
        leaves[name] = {"bit_equal": bool(torch.equal(a, b)), "max_abs_diff": (a.float() - b.float()).abs().max().item(),
                        "update_l2": (a.float() - b.float()).norm().item() / max(upd, 1e-30)}
    row = {
        "phase": "multi_step", "model": "gpt2_small", "batch_size": 8, "steps": MULTI_STEPS, "steps_per_call": MULTI_SPC,
        "samples_per_sec": {"single": single["summary"]["samples_per_sec"], "chunked": multi["summary"]["samples_per_sec"]},
        "wall_s": {"single": single["summary"]["wall_time_s"], "chunked": multi["summary"]["wall_time_s"]},
        "losses": {"single": single["losses"], "chunked": multi["losses"]}, "loss_max_rel": loss_rel,
        "losses_bit_equal": multi["losses"] == single["losses"],
        "params_bit_equal": all(v["bit_equal"] for v in leaves.values()),
        "worst_leaf_update_l2": max(v["update_l2"] for v in leaves.values()),
        "leaves_not_bit_equal": {k: v for k, v in leaves.items() if not v["bit_equal"]},
        "launches": {"single": single["launches"], "chunked": multi["launches"]}, "launches_expected": expect,
        "tol": tol,
    }
    if len(multi["losses"]) != MULTI_STEPS or len(single["losses"]) != MULTI_STEPS \
            or not all(math.isfinite(x) for x in multi["losses"] + single["losses"]):
        failures.append("missing or non-finite losses")
    if loss_rel > tol["loss"] or row["worst_leaf_update_l2"] > tol["update_l2"]:
        failures.append(f"chunked run outside PARITY_TOL['multi']: loss {loss_rel}, update {row['worst_leaf_update_l2']}")
    if single["launches"] != expect or multi["launches"] != expect:
        failures.append(f"K1-K3 launches {single['launches']} / {multi['launches']} != {expect}")
    del runs, p0, single, multi
    # Eval: the held-out synthetic stream through evaluate() (the run's
    # finite stream is spent: without data, eval draws its own generator's
    # batches), then one batch through the kernels and the plain core.
    trainer._data = None
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    ev = trainer.evaluate(EVAL_BATCHES)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = dict(fa.LAUNCHES)
    eval_expect = {"flash_fwd": 12 * EVAL_BATCHES, "flash_dq": 0, "flash_dkv": 0}
    eval_fn = make_eval_step(bundle.loss_fn)
    batch = {k: v.to("cuda") for k, v in bundle.make_batch(torch.Generator().manual_seed(12), 8).items()}
    rng = torch.Generator(device="cuda").manual_seed(0)
    loss_k = float(eval_fn(trainer.state.params, batch, rng)["loss"])
    set_attention_impl("xla")
    try:
        loss_p = float(eval_fn(trainer.state.params, batch, rng)["loss"])
    finally:
        set_attention_impl("auto")
    row["eval"] = {"eval_loss": ev, "batches": EVAL_BATCHES, "s": eval_s, "launches": eval_launches,
                   "launches_expected": eval_expect, "loss_kernels": loss_k, "loss_plain": loss_p,
                   "loss_rel": abs(loss_k - loss_p) / abs(loss_p), "tol": PARITY_TOL["eval"]}
    emit(row)
    if not math.isfinite(ev) or eval_launches != eval_expect:
        failures.append(f"eval: loss {ev}, launches {eval_launches} != {eval_expect}")
    if row["eval"]["loss_rel"] > PARITY_TOL["eval"]["loss"]:
        failures.append(f"eval loss through the kernels {loss_k} vs the plain core {loss_p}")
    del trainer
    release_card_memory()
    if failures:
        raise AssertionError(f"multi_step phase: {failures}")
    return {"multi_step": expect, "eval": eval_launches}


class GradHooks:
    """grad_averaging's own checks: after the last step, the two volunteers'
    params agree within ``adam_drift_bound`` of the steps' learning rates
    (every round committed on both), leaf by leaf on the card."""

    def setup(self, vols, recs) -> None:
        self.lrs = [vols[0].trainer.tx.schedule(c) for c in range(GRAD_STEPS)]
        # The weight each volunteer puts on its contribution, as the
        # averager receives it.
        self.weights = []
        for vol in vols:
            inner = vol.averager.average

            async def average(tree, round_no, weight, inner=inner):
                self.weights.append(weight)
                return await inner(tree, round_no=round_no, weight=weight)

            vol.averager.average = average

    def finish(self, vols, recs, failures) -> dict:
        from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

        tx = vols[0].trainer.tx
        bound = adam_drift_bound(self.lrs, tx.b1, tx.b2, GRAD_EPS)
        worst = {"excess": -math.inf}
        for name, a, b in zip(leaf_names(vols[0].trainer.state.params), tree_leaves(vols[0].trainer.state.params),
                              tree_leaves(vols[1].trainer.state.params)):
            diff = (a.float() - b.float()).abs().max().item()
            limit = bound + 2 * GRAD_STEPS * 2.0**-24 * max(a.float().abs().max().item(), b.float().abs().max().item())
            if diff - limit > worst["excess"]:
                worst = {"leaf": name, "max_abs_diff": diff, "limit": limit, "excess": diff - limit}
        committed = [r.committed() for r in recs]
        out = {"param_agreement": {"bound": bound, "lrs": self.lrs, "grad_eps": GRAD_EPS, "worst": worst,
                                   "committed": committed}}
        if committed != [GRAD_STEPS, GRAD_STEPS]:
            failures.append(f"gradient rounds committed {committed}, want {GRAD_STEPS} on each (param bound)")
        elif worst["excess"] > 0:
            failures.append(f"volunteers' params differ beyond the bound: {worst}")
        weights = sorted(set(self.weights))
        out["weights"] = weights
        if weights != [8.0]:
            failures.append(f"gradient contributions weighed {weights}, want one batch (8)")
        return out


class OuterHooks:
    """outer_sync's own checks. Each committed round's result (the plain
    average the volunteer's callback returned) is kept, and after the merge
    (``on_step`` of that step) a copy of the live params is taken on the
    card, which is all the trainer thread pays. After training, a Nesterov
    recurrence in numpy on flat buffers replays the results: round 1's
    expected params are the average itself, later rounds' a' = a - lr (mu m
    + g), g = a - v, m = mu m + g; every copy must be bit-equal to it. Then
    volunteer 0's checkpoint (with its ``.outer.npz`` sidecar) is saved, its
    outer state cleared and restored: anchor and momentum bit-equal, and
    equal to the recurrence's."""

    def setup(self, vols, recs) -> None:
        from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

        self.rounds = [[], []]  # per volunteer: [step, result tree, params on the card]
        for i, (vol, rec) in enumerate(zip(vols, recs)):
            prev_after, pending = rec.after, {}

            def after(call, result, prev_after=prev_after, pending=pending):
                prev_after(call, result)
                if result is not None:
                    pending[call["step"]] = result

            def on_step(trainer, step_no, i=i, pending=pending, inner=vol.trainer.on_step):
                result = pending.pop(step_no, None)
                if result is not None:
                    live = tree_leaves(trainer.bundle.avg_select(trainer.state.params))
                    self.rounds[i].append([step_no, result, torch.cat([p.detach().reshape(-1).float() for p in live])])
                if inner is not None:
                    inner(trainer, step_no)

            rec.after = after
            vol.trainer.on_step = on_step

    def finish(self, vols, recs, failures) -> dict:
        import shutil

        import numpy as np

        from distributedvolunteercomputing_tpu_torch.training import checkpoint
        from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

        lr, mu = OUTER["outer_lr"], OUTER["outer_momentum"]
        checks, final = [[], []], [None, None]
        for i, rounds in enumerate(self.rounds):
            a = m = None
            for step_no, result, live in rounds:
                v = flatten_to_buffer(result)[0]
                if a is None:
                    a, m, want = v.copy(), np.zeros_like(v), v
                else:
                    g = a - v
                    m = mu * m + g
                    a = a - lr * (mu * m + g)
                    want = a
                got = live.cpu().numpy()
                checks[i].append({"step": step_no, "round": len(checks[i]) + 1,
                                  "bit_equal": bool(np.array_equal(got.view(np.uint32), want.view(np.uint32))),
                                  "max_abs_diff": float(np.abs(got - want).max())})
            final[i] = (a, m)
        self.rounds = None
        out = {"merged_vs_host_nesterov": checks}
        for i, c in enumerate(checks):
            if len(c) < OUTER_COMMITS or not all(r["bit_equal"] for r in c):
                failures.append(f"volunteer {i}: merged params vs the host Nesterov step {c}")
        trainer = vols[0].trainer
        ckpt_dir = HERE / "build" / "chip_smoke" / "outer_ckpt"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        try:
            anchor = flatten_to_buffer(trainer._outer_anchor)[0]
            m = flatten_to_buffer(trainer._outer_m)[0]
            t0 = time.perf_counter()
            path = checkpoint.save(trainer, str(ckpt_dir))
            save_s = time.perf_counter() - t0
            trainer._outer_anchor = trainer._outer_m = None
            t0 = time.perf_counter()
            restored = checkpoint.maybe_restore(trainer, str(ckpt_dir))
            restore_s = time.perf_counter() - t0
            got_a = flatten_to_buffer(trainer._outer_anchor)[0] if trainer._outer_anchor is not None else None
            got_m = flatten_to_buffer(trainer._outer_m)[0] if trainer._outer_m is not None else None
            with np.load(path + ".outer.npz") as d:
                files = sorted(d.files)
            want_a, want_m = final[0]
            out["sidecar"] = {
                "files": files, "restored": restored, "save_s": save_s, "restore_s": restore_s,
                "anchor_bit_equal": got_a is not None and bool(np.array_equal(got_a.view(np.uint32), anchor.view(np.uint32))),
                "m_bit_equal": got_m is not None and bool(np.array_equal(got_m.view(np.uint32), m.view(np.uint32))),
                "anchor_is_recurrence": want_a is not None and bool(np.array_equal(anchor.view(np.uint32),
                                                                                   want_a.view(np.uint32))),
                "m_is_recurrence": want_m is not None and bool(np.array_equal(m.view(np.uint32), want_m.view(np.uint32))),
            }
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        sc = out["sidecar"]
        if not (sc["restored"] and sc["files"] == ["anchor", "m"] and sc["anchor_bit_equal"] and sc["m_bit_equal"]
                and sc["anchor_is_recurrence"] and sc["m_is_recurrence"]):
            failures.append(f"outer sidecar round trip: {sc}")
        return out


def grad_averaging_phase() -> dict:
    """Two gpt2_small volunteers at ``DEPTH_CUT`` in gradient mode: a sync
    round on the bf16 wire every step for ``GRAD_STEPS`` steps (phase 6's
    checks on every round, K1-K3 per step, ``GradHooks``)."""
    return averaging_phase(phase="grad_averaging", every=1, extra={"average_what": "grads"}, commits=None,
                           max_steps=GRAD_STEPS, keep=GRAD_STEPS, hooks=GradHooks(), all_rounds=True,
                           check_flash=True, overrides=DEPTH_CUT)


def outer_sync_phase() -> dict:
    """Two gpt2_small volunteers at ``DEPTH_CUT`` in sync rounds every
    ``AVG_EVERY`` steps with the outer Nesterov step (``OUTER``), until
    ``OUTER_COMMITS`` rounds have committed on each (phase 6's checks,
    ``OuterHooks``)."""
    return averaging_phase(phase="outer_sync", extra=dict(OUTER), commits=OUTER_COMMITS, hooks=OuterHooks(),
                           check_flash=True, overrides=DEPTH_CUT)


def mnist_file_phase(out_dir: Path) -> dict:
    """Capability config 6: ``run_volunteer_torch.py`` on mnist_mlp with
    ``--data`` (a file from ``experiments/make_npz.py``) and a held-out eval
    stream (``MNIST_FILE_ARGV``): exit 0, the target 0.15 crossed, an
    ``eval`` event with a finite loss at every multiple of 50 reached."""
    data = make_npz("mnist", out_dir)
    metrics = out_dir / "mnist_file_volunteer.jsonl"
    metrics.unlink(missing_ok=True)
    argv = [*MNIST_FILE_ARGV, "--data", str(data), "--metrics", str(metrics)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(HERE / "run_volunteer_torch.py"), *argv], cwd=str(HERE),
                          capture_output=True, text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("VOLUNTEER_DONE ")]
    summary = json.loads(done[-1].split(" ", 1)[1]) if done else {}
    events = read_jsonl(metrics) if metrics.exists() else []
    evals = [(e["step"], e["eval_loss"]) for e in events if e.get("event") == "eval"]
    steps = summary.get("steps") or 0
    want_steps = list(range(50, steps + 1, 50))
    row = {"phase": "mnist_file", "argv": MNIST_FILE_ARGV, "rc": proc.returncode, "wall_s": wall_s,
           "data": {"file": data.name, "bytes": data.stat().st_size}, "evals": evals,
           **{k: summary.get(k) for k in ("steps", "final_loss", "target_crossed_step", "target_crossed_s",
                                          "samples_per_sec", "wall_time_s")}}
    emit(row)
    if proc.returncode != 0 or row["target_crossed_step"] is None:
        raise AssertionError(f"mnist_file phase: rc {proc.returncode}, summary {summary}: {proc.stderr[-3000:]}")
    if [s for s, _ in evals] != want_steps or not want_steps or not all(math.isfinite(x) for _, x in evals):
        raise AssertionError(f"mnist_file phase: eval events {evals}, want one at each of {want_steps}")
    return row


def resnet_file_phase(out_dir: Path) -> dict:
    """Capability config 7: phase 16 (config 2) with both volunteers reading
    ``--data`` (a cifar10 file from ``experiments/make_npz.py``), each in its
    own per-peer order."""
    data = make_npz("cifar10", out_dir)
    return averaging_phase(phase="resnet_file", **RESNET, extra={"data_path": str(data)})


# ---------------------------------------------------------------------------
# lifecycle: coordinator, checkpoints, preemption, state sync on join
# ---------------------------------------------------------------------------

LIFE_EVERY = 2  # averaging cadence (steps)
LIFE_CKPT_EVERY = 4  # A's checkpoint cadence (steps)
LIFE_COMMITS = 2  # rounds A and B commit before A's preemption; then rounds the three commit together
LIFE_WAIT_S = 300.0  # cap on each wait of the phase
LIFE_CKPT_KEEP = "2"  # A's snapshots kept (DVC_CKPT_KEEP): ~1.49 GB each at full width


def read_jsonl(path) -> list:
    """The records of a JSONL file another process may be appending to."""
    out = []
    if not Path(path).exists():
        return out
    for line in Path(path).read_text().splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass  # a line still being written
    return out


def committed_rounds(records) -> int:
    return sum(1 for r in records if r.get("event") == "avg_round" and r.get("ok"))


class LifeRecorder:
    """Wraps an in-process volunteer's averager callback and its group
    formation: each committed round with the size of its group and its
    seconds. A round whose group holds a member that never contributes (a
    departed peer whose rendezvous record is still live) commits only at
    the gather deadline, without it; a round of ``size`` that commits
    sooner had all ``size`` contributions."""

    def __init__(self, vol):
        self.rounds = []  # (group size, step, seconds) per committed round
        self.deadline_s = vol.cfg.round_deadline_s or vol.cfg.gather_timeout
        self._size = 0
        inner, form_group = vol._averager_callback, vol.averager._form_group

        async def counted_form_group(round_key):
            group = await form_group(round_key)
            self._size = len(group.members) if group is not None else 0
            return group

        def cb(params, step):
            t0 = time.perf_counter()
            result = inner(params, step)
            if result is not None:
                self.rounds.append((self._size, step, time.perf_counter() - t0))
            return result

        vol.averager._form_group = counted_form_group
        vol.trainer.averager = cb

    def together(self, size: int, since: int = 0) -> int:
        """Rounds since the ``since``-th that all ``size`` members fed."""
        return sum(1 for n, _, sec in self.rounds[since:] if n == size and sec < self.deadline_s)


def lifecycle_phase() -> dict:
    """The flagship volunteer's whole life on the card, from the port's own
    entry scripts (see the module doc)."""
    import os
    import shutil
    import signal
    import tempfile

    import numpy as np

    from distributedvolunteercomputing_tpu_torch import native
    from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.swarm import volunteer as vol_mod
    from distributedvolunteercomputing_tpu_torch.swarm.state_sync import StateSyncService
    from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport
    from distributedvolunteercomputing_tpu_torch.training.checkpoint import latest_step
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

    if not native.ensure_built():
        raise RuntimeError("the host codec's C++ core did not build")
    (HERE / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="lifecycle_", dir=HERE / "build"))
    torch.cuda.empty_cache()  # A's process shares the card with this one
    ckpt_a = tmp / "ckpt_a"
    paths = {k: tmp / f"{k}.jsonl" for k in ("A1", "A2", "B", "C", "coord")}
    procs = {}
    failures = []

    class RecordingSync(StateSyncService):
        """The state-sync service of the in-process volunteers, keeping what
        its pull returned."""

        pulled = None

        async def pull(self, *a, **kw):
            self.pulled = await super().pull(*a, **kw)
            return self.pulled

    async def spawn(name, *argv, env=None):
        log_path = tmp / f"{name}.log"
        procs[name] = (await asyncio.create_subprocess_exec(
            sys.executable, *map(str, argv), cwd=str(HERE), env=env,
            stdout=asyncio.subprocess.PIPE if name == "coord" else open(tmp / f"{name}.out", "w"),
            stderr=open(log_path, "w"),
        ), log_path)
        return procs[name][0]

    def log_tail(name, n=3000) -> str:
        p = procs[name][1] if name in procs else None
        return p.read_text()[-n:] if p is not None and p.exists() else ""

    async def wait_for(what, cond, alive=()):
        deadline = time.monotonic() + LIFE_WAIT_S
        while not cond():
            for name in alive:
                if procs[name][0].returncode is not None:
                    raise AssertionError(f"{name} exited ({procs[name][0].returncode}) waiting for {what}: "
                                         f"{log_tail(name)}")
            if time.monotonic() > deadline:
                raise AssertionError(f"lifecycle: timed out waiting for {what}")
            await asyncio.sleep(0.5)

    async def stop_proc(name, timeout=180.0) -> int:
        proc = procs[name][0]
        if proc.returncode is None:
            proc.send_signal(signal.SIGTERM)
            try:
                await asyncio.wait_for(proc.wait(), timeout)
            except asyncio.TimeoutError:
                proc.kill()
                await proc.wait()
                raise AssertionError(f"{name} did not exit within {timeout}s of SIGTERM")
        return proc.returncode

    def volunteer_argv(metrics):
        return [HERE / "run_volunteer_torch.py", "--model", "gpt2_small", "--batch-size", "8",
                *[a for k, v in DEPTH_CUT.items() for a in ("--model-override", f"{k}={v}")],
                "--averaging", "sync", "--wire", "bf16", "--average-every", LIFE_EVERY, "--no-overlap",
                "--coordinator", addr, "--checkpoint-dir", ckpt_a, "--checkpoint-every", LIFE_CKPT_EVERY,
                "--metrics", metrics, "--peer-id", "volA", "--seed", "1", "--steps", 100000]

    def in_process(peer, seed):
        return vol_mod.Volunteer(vol_mod.VolunteerConfig(
            peer_id=peer, seed=seed, coordinator=addr, model="gpt2_small", model_overrides=dict(DEPTH_CUT),
            batch_size=8, averaging="sync", wire="bf16", average_every=LIFE_EVERY, overlap=False, steps=100000,
            metrics_path=str(paths[peer[-1]]),
        ))

    async def coord_view(client):
        status, _ = await client.call(addr_t, "coord.status", {}, timeout=10.0)
        latest = {}
        for rec in read_jsonl(paths["coord"]):
            latest[rec.get("peer")] = rec
        return status, latest

    def report_checks(status, latest) -> list:
        bad = []
        peers = ("volA", "volB", "volC")
        per_peer = (status.get("telemetry") or {}).get("per_peer") or {}
        for p in peers:
            rep = latest.get(p) or {}
            codec = rep.get("mesh_codec") or {}
            flushes = (rep.get("aggregation") or {}).get("folder_flushes", 0)
            k = codec.get("launches") or {}
            if p not in status["alive"] or p not in per_peer:
                bad.append(f"{p} not in coord.status")
            if codec.get("backend") != "device" or k.get("bf16_encode", 0) < 1:
                bad.append(f"{p}: codec {codec}")
            if p in ("volB", "volC") and codec.get("ops_host", 1) != 0:
                bad.append(f"{p}: codec ops off the card {codec}")
            if k.get("bf16_fold_chunks", 0) < flushes:
                bad.append(f"{p}: K5 launches {k} < its folder's {flushes} flushes")
            if not isinstance(rep.get("watchdog"), dict):
                bad.append(f"{p}: no watchdog summary in its report")
        if (status.get("alerts") or {}).get("reporting", 0) < 3:
            bad.append(f"watchdog summaries reporting: {status.get('alerts')}")
        if not any((latest.get(p, {}).get("mesh_codec") or {}).get("launches", {}).get("bf16_fold_chunks")
                   for p in peers):
            bad.append("no report shows a K5 launch")
        return bad

    async def main():
        nonlocal addr, addr_t
        env_a = {**os.environ, "DVC_CKPT_KEEP": LIFE_CKPT_KEEP}
        coord = await spawn("coord", HERE / "coordinator_torch.py", "--port", "0", "--metrics", paths["coord"])
        line = await asyncio.wait_for(coord.stdout.readline(), 120)
        if not line.startswith(b"COORDINATOR_READY"):
            raise AssertionError(f"coordinator: {line!r} {log_tail('coord')}")
        addr = line.split()[1].decode()
        host, port = addr.rsplit(":", 1)
        addr_t = (host, int(port))
        vol_mod.StateSyncService = RecordingSync
        vols, tasks = {}, {}
        client = Transport()
        await client.start()
        t_phase = time.perf_counter()
        try:
            # 1-2. A (entry script, a process of its own) and B (in this
            # process) train together until each has committed rounds.
            await spawn("A1", *volunteer_argv(paths["A1"]), env=env_a)
            vols["B"] = in_process("volB", 2)
            await vols["B"].start()
            rec_b = LifeRecorder(vols["B"])
            torch.cuda.synchronize()
            reset_all_launch_counts()
            tasks["B"] = asyncio.create_task(vols["B"].train())
            await wait_for("A and B to commit rounds", lambda: committed_rounds(read_jsonl(paths["A1"])) >= LIFE_COMMITS
                           and len(rec_b.rounds) >= LIFE_COMMITS, alive=("A1",))
            # 3. Preempt A: it exits 0 after its final checkpoint.
            rc = await stop_proc("A1")
            a1 = read_jsonl(paths["A1"])
            done = [ln for ln in (tmp / "A1.out").read_text().splitlines() if ln.startswith("VOLUNTEER_DONE ")]
            a1_steps = json.loads(done[-1].split(" ", 1)[1])["steps"] if done else None
            final_step = latest_step(str(ckpt_a))
            if rc != 0 or final_step is None or final_step != a1_steps:
                raise AssertionError(f"A on SIGTERM: rc {rc}, final step_N {final_step}, its steps {a1_steps}: "
                                     f"{log_tail('A1')}")
            # 4. C joins while B is the only live provider.
            served = {}
            inner = vols["B"].state_sync._provider

            def recording_provider():
                step, tree = inner()
                served[step] = tree
                return step, tree

            vols["B"].state_sync.set_provider(recording_provider)
            vols["C"] = in_process("volC", 3)
            await vols["C"].start()
            pulled = vols["C"].state_sync.pulled
            if pulled is None:
                raise AssertionError("C's pull returned None while B provides state")
            c_step, c_tree = pulled
            got = flatten_to_buffer(vols["C"].trainer.state.params)[0]
            want = flatten_to_buffer(c_tree)[0]
            wire = native.bf16_to_f32(native.f32_to_bf16(flatten_to_buffer(served[c_step])[0]))
            late_join = {
                "pulled_step": c_step, "trainer_step": vols["C"].trainer.state.step,
                "params_bit_equal_pulled": got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes(),
                "pulled_bit_equal_served_bf16": want.view(np.uint32).tobytes() == wire.view(np.uint32).tobytes(),
            }
            if not (c_step >= 2 and late_join["trainer_step"] == c_step and late_join["params_bit_equal_pulled"]
                    and late_join["pulled_bit_equal_served_bf16"]):
                raise AssertionError(f"late join: {late_join}")
            rec_c = LifeRecorder(vols["C"])
            tasks["C"] = asyncio.create_task(vols["C"].train())
            # 5. A restarts from its checkpoint once B is ahead of it, and
            # catches up by state sync.
            await wait_for("B to step past A's checkpoint",
                           lambda: vols["B"].trainer.state.step > final_step + LIFE_EVERY)
            since = (len(rec_b.rounds), len(rec_c.rounds))
            await spawn("A2", *volunteer_argv(paths["A2"]), env=env_a)
            await wait_for("A's restore and pull", lambda: any(
                r.get("event") == "state_pull" for r in read_jsonl(paths["A2"])), alive=("A2",))
            a2 = read_jsonl(paths["A2"])
            restored = [r for r in a2 if r.get("event") == "ckpt_restored"]
            a_pull = [r for r in a2 if r.get("event") == "state_pull"][0]
            if not restored or restored[0]["step"] != final_step:
                raise AssertionError(f"A's restore {restored} != its final step_{final_step}")
            if not (a_pull["pulled"] and a_pull["step"] > final_step):
                raise AssertionError(f"A's catch-up pull {a_pull} after its restore at step {final_step}")
            await wait_for("A, B and C to commit rounds together", lambda: min(
                rec_b.together(3, since[0]), rec_c.together(3, since[1])) >= LIFE_COMMITS
                and committed_rounds(read_jsonl(paths["A2"])) >= LIFE_COMMITS, alive=("A2",))
            # 6. The coordinator's view: the reports of all three.
            deadline = time.monotonic() + 60.0
            while True:
                status, latest = await coord_view(client)
                bad = report_checks(status, latest)
                if not bad or time.monotonic() > deadline:
                    break
                await asyncio.sleep(1.0)
            failures.extend(bad)
            run_s = time.perf_counter() - t_phase
            # All three stop together, as far as they can: a round whose
            # peer stopped first waits out its gather deadline.
            for v in vols.values():
                v._stop.set()
            procs["A2"][0].send_signal(signal.SIGTERM)
            summaries = dict(zip(tasks, await asyncio.gather(*tasks.values())))
            torch.cuda.synchronize()
            launches = {**dict(mc.LAUNCHES), **dict(fa.LAUNCHES)}
            rc2 = await stop_proc("A2")
            if rc2 != 0:
                failures.append(f"A's second life exited {rc2}: {log_tail('A2')}")
            return dict(status=status, latest=latest, summaries=summaries, launches=launches, run_s=run_s,
                        late_join=late_join, final_step=final_step, restored=restored[0], a_pull=a_pull,
                        a1=a1, rec={"B": rec_b.rounds, "C": rec_c.rounds},
                        together={"B": rec_b.together(3, since[0]), "C": rec_c.together(3, since[1])})
        finally:
            vol_mod.StateSyncService = StateSyncService
            for v in vols.values():
                v._stop.set()
            for t in tasks.values():
                try:
                    await asyncio.wait_for(t, 120)
                except BaseException:  # noqa: BLE001 — teardown; the failure already raised
                    pass
            await asyncio.gather(*(v.stop() for v in vols.values()), return_exceptions=True)
            await client.close()
            for name in procs:
                try:
                    code = await stop_proc(name, timeout=60.0)
                    if name == "coord" and code != 0:
                        failures.append(f"coordinator exited {code}: {log_tail('coord')}")
                except AssertionError as e:
                    failures.append(str(e))

    addr, addr_t = "", None
    try:
        res = asyncio.run(main())
        recs = {k: read_jsonl(paths[k]) for k in ("A1", "A2", "B", "C")}
        coord_reports = read_jsonl(paths["coord"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def rounds_s(records):
        return [r["avg_s"] for r in records if r.get("event") == "avg_round" and r.get("ok")]

    losses = {k: [r["loss"] for r in v if "loss" in r] for k, v in recs.items()}
    ran = {k: len(losses[k]) for k in ("B", "C")}
    k1, k2, k3 = flash_per_step("gpt2_small", DEPTH_CUT)
    expect_flash = {"flash_fwd": k1 * sum(ran.values()), "flash_dq": k2 * sum(ran.values()),
                    "flash_dkv": k3 * sum(ran.values())}
    agg = {k: s.get("aggregation", {}) for k, s in res["summaries"].items()}
    k5_expected = sum(a.get("folder_flushes", 0) for a in agg.values())
    pulls = {"C": [r for r in recs["C"] if r.get("event") == "state_pull"], "A": [res["a_pull"]]}
    status = res["status"]
    row = {
        "phase": "lifecycle", "model": "gpt2_small", "overrides": DEPTH_CUT, "batch_size": 8, "wire": "bf16",
        "overlap": False,
        "average_every": LIFE_EVERY, "checkpoint_every": LIFE_CKPT_EVERY, "commits": LIFE_COMMITS,
        "run_s": res["run_s"],
        "rounds_ok": {k: committed_rounds(v) for k, v in recs.items()},
        "round_s": {k: rounds_s(v) for k, v in recs.items()},
        "rounds_together_after_A_restart": res["together"],
        "rounds_in_process": res["rec"],  # (group size, step, seconds) per committed round
        "steps_run": {k: len(v) for k, v in losses.items()},
        "state_pull": {k: [{f: p[f] for f in ("step", "from_step", "pulled", "s", "bytes")} for p in v]
                       for k, v in pulls.items()},
        "late_join": res["late_join"],
        "checkpoint": {
            "host_copy_ms": [r["ms"] for r in res["a1"] if r.get("event") == "ckpt_host_copy"],
            "write_s": [r["write_s"] for r in res["a1"] if r.get("event") == "ckpt_saved"],
            "final_step": res["final_step"], "restore_s": res["restored"]["restore_s"],
            "restored_step": res["restored"]["step"],
        },
        "coordinator": {
            "report_lines": len(coord_reports), "reports": status["control_plane"].get("reports"),
            "exchanges": status["control_plane"].get("exchanges"), "alive": sorted(status["alive"]),
            "watchdog_reporting": (status.get("alerts") or {}).get("reporting"),
            "codec": {p: (res["latest"].get(p) or {}).get("mesh_codec") for p in ("volA", "volB", "volC")},
        },
        "launches": res["launches"], "launches_expected": {**expect_flash, "bf16_fold_chunks": k5_expected},
    }
    emit(row)
    if any(not v or not all(math.isfinite(x) for x in v) for v in losses.values()):
        failures.append(f"missing or non-finite losses: { {k: len(v) for k, v in losses.items()} }")
    if {k: res["launches"][k] for k in expect_flash} != expect_flash:
        failures.append(f"K1-K3 launches {res['launches']} != {expect_flash} for B and C's {ran} steps")
    if res["launches"]["bf16_encode"] < 1 or res["launches"]["bf16_fold_chunks"] != k5_expected:
        failures.append(f"K4/K5 launches {res['launches']}: K5 != the folders' {k5_expected} flushes")
    if not pulls["C"] or not pulls["C"][0]["pulled"]:
        failures.append(f"C's pull: {pulls['C']}")
    if failures:
        raise AssertionError(f"lifecycle phase: {failures}")
    return res["launches"]


# ---------------------------------------------------------------------------
# protocols: gossip, butterfly on the wall-clock cadence, Byzantine rounds
# ---------------------------------------------------------------------------

# The script's time limit (1200 s) holds every phase: the phases that put
# several volunteers on this process's event loop train gpt2_small (and
# config 3's BERT-base) at their published widths with the depth cut to this
# many layers (PERF.md section 4). At 12 layers a round moves 249 MB per
# contribution through that one loop, and such phases fell out of step and
# waited out their gather ceilings (60-150 s a phase, run to run); cut, their
# times held from run to run. Their checks are unchanged; K1-K3 are counted
# per step of the cut model. Phases 6 (averaging), 25 (failover) and 26
# (hedge) keep the full model.
DEPTH_CUT = {"n_layers": 2}
PROTO_EVERY = 2  # the step cadence of the gossip and Byzantine phases
PROTO_MAX_STEPS = 400  # cap on each trainer's steps; the phases end on their round counts
PROTO_WAIT_S = 300.0  # cap on each phase's training, and on the attacker's start
# Each phase puts two to four full-width volunteers on one event loop, so a
# round moves several 249 MB buffers through one Python loop, where the
# reference's ceilings (20 s gather, 8 s per butterfly stage) are sized for
# one volunteer per process: on a slow host, stages timed out at 8 s. The
# phases' volunteers (the attacker too) get these ceilings instead.
PROTO_GATHER_S = 60.0
BFLY_STAGE_S = 30.0
GOSSIP_MIXES = 2  # successful exchanges each gossip volunteer must make
BFLY_N = 4  # butterfly volunteers: two hypercube stages
BFLY_INTERVAL_S = 10.0  # the wall-clock cadence (AUTO's 20 s is held on the CPU)
BFLY_ROUNDS = 2  # rounds in which both stages mixed, on each volunteer
BYZ_ROUNDS = 2  # Byzantine rounds all three fed, on each honest volunteer
BYZ_SCALE = "-4"  # the attacker's DVC_CHAOS_CONTRIB_SCALE


def cuda_sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def proto_limit(stages: int, scale):
    tol = AVG_TOL
    return (stages * tol["bf16_u"] + tol["f32_ulps"]) * scale + tol["floor"]


def release_card_memory() -> None:
    """The volunteers of earlier phases hold card memory until collected."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


async def start_volunteers(n, out_dir, what, first: int = 0, coordinator=None, model: str = "gpt2_small",
                           batch_size: int = 8, per=None, **kw):
    """In-process volunteers ``first`` .. ``first + n - 1`` of one phase,
    ``model`` at full width (gpt2_small, batch 8 by default), blocking
    rounds on the bf16 wire, bootstrapping from ``coordinator``, else from
    the first of them; ``per(i)`` adds volunteer i's own config fields. Each
    gets ``init_memory``: the card memory its start left resident and the
    peak above what was allocated before it."""
    from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig

    release_card_memory()
    vols, paths = [], []
    for i in range(first, first + n):
        paths.append(out_dir / f"{what}_volunteer{i}.jsonl")
        paths[-1].unlink(missing_ok=True)
        boot = coordinator or ("%s:%d" % vols[0].transport.addr if vols else None)
        fields = dict(
            model=model, batch_size=batch_size, wire="bf16", overlap=False, steps=PROTO_MAX_STEPS,
            mesh_codec="mesh", gather_timeout=PROTO_GATHER_S, peer_id=f"{what}{i}", seed=i + 1,
            metrics_path=str(paths[-1]), coordinator=boot,
        )
        fields.update(kw, **(per(i) if per else {}))
        vols.append(Volunteer(VolunteerConfig(**fields)))
        cuda_sync()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        await vols[-1].start()
        cuda_sync()
        vols[-1].init_memory = {"resident_bytes": torch.cuda.memory_allocated() - before,
                                "peak_bytes": torch.cuda.max_memory_allocated() - before}
    return vols, paths


async def train_until(vols, recs, what: str):
    """Train the phase's in-process volunteers, all starting together, until
    every recorder is done, within ``PROTO_WAIT_S``; returns the summaries
    and seconds."""

    def stop_all():
        for v in vols:
            v._stop.set()

    for r in recs:
        r.stop_all = stop_all
    cuda_sync()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    tasks = [asyncio.create_task(v.train()) for v in vols]
    try:
        summaries = await asyncio.wait_for(asyncio.gather(*tasks), PROTO_WAIT_S)
    except asyncio.TimeoutError:
        stop_all()
        await asyncio.gather(*tasks, return_exceptions=True)
        calls = [[{k: c[k] for k in ("step", "ok", "size", "degraded", "outcomes")} for c in r.calls] for r in recs]
        raise AssertionError(f"{what}: not done within {PROTO_WAIT_S} s: {calls}")
    run_s = time.perf_counter() - t0
    cuda_sync()
    return summaries, run_s, proto_launches()


def proto_launches() -> dict:
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc

    return {**flash_launches(), **dict(mc.LAUNCHES)}


def flash_per_step(model: str, overrides=None) -> tuple:
    """K1 / K2 / K3 launches per train step of ``model`` at its registry
    config: each attention layer's forward runs twice under remat (the
    forward and backward's recompute), its dq and dk/dv once; none for the
    models without attention."""
    from distributedvolunteercomputing_tpu_torch.models import get_model

    cfg = get_model(model, **(overrides or {})).config
    layers = getattr(cfg, "n_layers", 0) if hasattr(cfg, "n_heads") else 0
    return ((2 if cfg.remat else 1) * layers, layers, layers) if layers else (0, 0, 0)


def proto_checks(what, vols, summaries, paths, launches, failures, model: str = "gpt2_small",
                 overrides=None, codec_ops: bool = True) -> dict:
    """Finite losses; K1-K3 launches per step of this process's volunteers
    as ``flash_per_step`` (24 / 12 / 12 for gpt2_small); every codec op on
    the card, and (``codec_ops``) some op run there: the q8 and topk wires'
    rounds run none (their codecs and the sync mean are the host's)."""
    losses = [[r["loss"] for r in read_jsonl(p) if "loss" in r] for p in paths]
    steps = sum(len(ls) for ls in losses)
    k1, k2, k3 = flash_per_step(model, overrides)
    expect_flash = {"flash_fwd": k1 * steps, "flash_dq": k2 * steps, "flash_dkv": k3 * steps}
    codec = vols[0].averager.mesh_codec.stats()
    if not all(losses) or not all(math.isfinite(x) for ls in losses for x in ls):
        failures.append(f"{what}: missing or non-finite losses")
    if {k: launches[k] for k in expect_flash} != expect_flash:
        failures.append(f"{what}: K1-K3 launches {launches} != {expect_flash} for {steps} steps")
    if codec["backend"] != "device" or codec["ops_host"] != 0 or (codec_ops and codec["ops_mesh"] < 1):
        failures.append(f"{what}: codec ops off the card: {codec}")
    return {"steps_run": [len(ls) for ls in losses], "losses": losses,
            "final_loss": [s["final_loss"] for s in summaries], "mesh_codec": codec}


def k4_check(what, launches, k4_min, failures) -> None:
    if launches["bf16_encode"] < k4_min:
        failures.append(f"{what}: K4 launches {launches['bf16_encode']} < the {k4_min} its rounds imply")


def gossip_phase(model: str = "gpt2_small", n: int = 2, batch_size: int = 8, phase: str = "gossip",
                 **kw) -> dict:
    """``n`` full-width gossip volunteers of ``model`` in this process (two
    gpt2_small by default), params mode, the step cadence every
    ``PROTO_EVERY`` steps: each publishes at its start, then exchanges with
    a partner at each averaging point. Each exchange's mix is held against
    the weighted mean of the caller's buffer and the partner's as the
    partner served it (recorded in its ``gossip.exchange`` handler, by
    exchange id). ``kw`` goes to each ``VolunteerConfig``."""
    import numpy as np

    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    served = collections.OrderedDict()  # xid -> (weight, buffer) as its partner served it
    pending = [None] * n  # (xid, (weight, buffer) before the mix) of the call's exchange
    mixes = [collections.deque(maxlen=2) for _ in range(n)]
    exchanges = [0] * n
    failures = []

    def instrument(vol, i):
        avg, transport = vol.averager, vol.transport
        handler, call = avg._rpc_exchange, transport.call

        async def recording_handler(args, payload):
            mine = avg._current  # what the handler serves: read before its first await
            out = await handler(args, payload)
            served[args.get("xid")] = mine
            while len(served) > 4 * n:
                served.popitem(last=False)
            return out

        async def recording_call(addr, method, args=None, *a, **kw):
            before = avg._current
            out = await call(addr, method, args, *a, **kw)
            if method == "gossip.exchange":
                pending[i] = (args["xid"], before)
            return out

        transport.register("gossip.exchange", recording_handler)
        transport.call = recording_call
        rec = ProtoRecorder(vol, keep=0)

        def before():
            pending[i] = None

        def after(c, result):
            if pending[i] is not None and result is not None:
                xid, (pre_w, pre) = pending[i]
                post_w, post = avg._current
                exchanges[i] += 1
                mixes[i].append({"xid": xid, "pre_w": pre_w, "pre": pre, "post_w": post_w, "post": post,
                                 "step": c["step"], "s": c["s"], "partner": served.get(xid)})

        rec.before, rec.after = before, after
        rec.done = lambda _r: min(exchanges) >= GOSSIP_MIXES
        return rec

    async def run():
        vols, paths = await start_volunteers(n, out_dir, phase, model=model, batch_size=batch_size,
                                             averaging="gossip", average_every=PROTO_EVERY, **kw)
        try:
            recs = [instrument(v, i) for i, v in enumerate(vols)]
            return (vols, paths, recs, *await train_until(vols, recs, phase))
        finally:
            await asyncio.gather(*(v.stop() for v in vols))

    vols, paths, recs, summaries, run_s, launches = asyncio.run(run())
    row = {"phase": phase, "model": model, "overrides": kw.get("model_overrides"), "volunteers": n,
           "batch_size": batch_size, "wire": "bf16",
           "average_every": PROTO_EVERY, "gather_timeout": PROTO_GATHER_S,
           "run_s": run_s, "exchanges_ok": exchanges, "rounds_ok": [s["rounds_ok"] for s in summaries],
           "rounds_skipped": [s["rounds_skipped"] for s in summaries],
           "mix_s": [[c["s"] for c in r.calls if c["ok"]] for r in recs], "launches": launches,
           "params": vols[0].averager._specs and sum(sp.size for sp in vols[0].averager._specs),
           "init_memory": [v.init_memory for v in vols]}
    row.update(proto_checks(phase, vols, summaries, paths, launches, failures, model, kw.get("model_overrides")))
    if min(exchanges) < GOSSIP_MIXES:
        failures.append(f"{phase}: successful exchanges {exchanges} < {GOSSIP_MIXES} each")
    # K4: each successful exchange encodes the caller's buffer and the reply.
    k4_check(phase, launches, 2 * sum(exchanges), failures)
    values = []
    for i, recent in enumerate(mixes):
        for m in recent:
            if m["partner"] is None:
                failures.append(f"{phase}: volunteer {i}'s exchange {m['xid']} not seen served")
                continue
            my_w, mine = m["partner"]
            want = (m["pre_w"] * m["pre"].astype(np.float64) + my_w * mine) / (m["pre_w"] + my_w)
            err = np.abs(m["post"] - want)
            lim = proto_limit(PROTO_STAGES["gossip"], np.maximum(np.abs(m["pre"]), np.abs(mine)))
            v = {"volunteer": i, "step": m["step"], "weights": [m["pre_w"], my_w], "post_weight": m["post_w"],
                 "max_abs_err": float(err.max()), "limit_used": float((err / lim).max()),
                 "finite": bool(np.isfinite(m["post"]).all())}
            values.append(v)
            if not (v["finite"] and v["limit_used"] <= 1.0 and m["post_w"] == m["pre_w"] + my_w):
                failures.append(f"{phase}: mix outside its tolerance: {v}")
    if not values:
        failures.append(f"{phase}: no mix recorded with its partner's served half")
    row["values"] = values
    emit(row)
    if failures:
        raise AssertionError(f"{phase} phase: {failures}")
    return launches


def butterfly_phase() -> dict:
    """``BFLY_N`` full-width butterfly volunteers in this process on the
    wall-clock cadence (``BFLY_INTERVAL_S``, ClockSync on), groups of all
    four: every round runs both hypercube stages. The four results of a
    round must be bit-equal and within ``PROTO_STAGES["butterfly"]`` bf16
    roundings of the weighted mean of the four payloads."""
    import numpy as np

    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    stage_s = [[] for _ in range(BFLY_N)]  # per volunteer, per averaging call: seconds of each stage

    def instrument(vol, i):
        avg = vol.averager
        roundtrip, mix = avg._wire_roundtrip, avg._mix
        stages = []

        def timed_roundtrip(buf):  # a stage starts with its round trip
            stages.append([time.perf_counter(), None])
            return roundtrip(buf)

        def timed_mix(*a):  # and ends with its mix
            out = mix(*a)
            stages[-1][1] = time.perf_counter()
            return out

        avg._wire_roundtrip, avg._mix = timed_roundtrip, timed_mix
        avg.stage_timeout = BFLY_STAGE_S
        rec = ProtoRecorder(vol)
        rec.before = stages.clear
        rec.after = lambda c, r: stage_s[i].append([e - s if e else None for s, e in stages])
        return rec

    async def run():
        vols, paths = await start_volunteers(
            BFLY_N, out_dir, "butterfly", averaging="butterfly", average_interval_s=BFLY_INTERVAL_S,
            min_group=BFLY_N, max_group=BFLY_N, join_timeout=4.0, model_overrides=dict(DEPTH_CUT),
        )
        try:
            recs = [instrument(v, i) for i, v in enumerate(vols)]
            for r in recs:
                r.done = lambda _r: min(len(x.full_rounds(BFLY_N, 2)) for x in recs) >= BFLY_ROUNDS
            out = await train_until(vols, recs, "butterfly")
            return (vols, paths, recs, *out, [v.clocksync.offset for v in vols])
        finally:
            await asyncio.gather(*(v.stop() for v in vols))

    vols, paths, recs, summaries, run_s, launches, offsets = asyncio.run(run())
    full = [r.full_rounds(BFLY_N, 2) for r in recs]
    row = {"phase": "butterfly", "model": "gpt2_small", "overrides": DEPTH_CUT, "batch_size": 8, "wire": "bf16",
           "volunteers": BFLY_N,
           "average_interval_s": [v.cfg.average_interval_s for v in vols], "clock_offsets_s": offsets,
           "gather_timeout": PROTO_GATHER_S, "stage_timeout": BFLY_STAGE_S,
           "run_s": run_s, "rounds_ok": [s["rounds_ok"] for s in summaries],
           "rounds_skipped": [s["rounds_skipped"] for s in summaries],
           "rounds_degraded": [s["rounds_degraded"] for s in summaries],
           "full_rounds": [len(f) for f in full], "round_s": [[c["s"] for c in f] for f in full],
           "stage_s": stage_s, "launches": launches}
    row.update(proto_checks("butterfly", vols, summaries, paths, launches, failures, "gpt2_small", DEPTH_CUT))
    if min(len(f) for f in full) < BFLY_ROUNDS or any(v.clocksync is None for v in vols):
        failures.append(f"butterfly: rounds with both stages mixed {row['full_rounds']} < {BFLY_ROUNDS} each")
    # K4 per full round: each volunteer round-trips its buffer at each stage,
    # and each pair's exchange encodes the caller's buffer and the reply.
    k4_check("butterfly", launches, 2 * 2 * BFLY_N * min(len(f) for f in full), failures)
    by_epoch = collections.defaultdict(dict)
    for i, r in enumerate(recs):
        for b in r.buffers:
            by_epoch[b["epoch"]][i] = b
    values = []
    for epoch, got in by_epoch.items():
        if len(got) < BFLY_N or any(b["degraded"] or b["size"] != BFLY_N for b in got.values()):
            continue
        bs = [got[i] for i in range(BFLY_N)]
        ws = [b["weight"] for b in bs]
        want = sum(w * b["payload"].astype(np.float64) for w, b in zip(ws, bs)) / sum(ws)
        scale = np.max(np.stack([np.abs(b["payload"]) for b in bs]), axis=0)
        err = np.abs(bs[0]["result"] - want)
        v = {"epoch": epoch, "steps": [b["step"] for b in bs], "weights": ws,
             "bit_equal": all(b["result"].tobytes() == bs[0]["result"].tobytes() for b in bs),
             "max_abs_err": float(err.max()),
             "limit_used": float((err / proto_limit(PROTO_STAGES["butterfly"], scale)).max()),
             "finite": bool(np.isfinite(bs[0]["result"]).all())}
        values.append(v)
        if not (v["bit_equal"] and v["finite"] and v["limit_used"] <= 1.0):
            failures.append(f"butterfly: round values: {v}")
    if not values:
        failures.append("butterfly: no full round with all four results recorded")
    row["values"] = values
    emit(row)
    if failures:
        raise AssertionError(f"butterfly phase: {failures}")
    return launches


def bits_fingerprint(tree) -> list:
    """Per leaf, two int64 sums over its bit patterns (plain, and weighted
    by position mod 8191): any change of one element changes both. In
    slices of 2^26 elements, so the int64 copy stays small."""
    from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

    itype = {2: torch.int16, 4: torch.int32}
    out = []
    for leaf in tree_leaves(tree):
        flat = leaf.detach().reshape(-1).view(itype[leaf.element_size()])
        s1 = s2 = 0
        for lo in range(0, flat.numel(), 1 << 26):
            c = flat[lo: lo + (1 << 26)].to(torch.int64)
            w = (torch.arange(lo, lo + c.numel(), device=c.device) % 8191) + 1
            s1 += int(c.sum())
            s2 += int((c * w).sum())
        out.append((s1, s2))
    return out


class CardMemorySampler:
    """The card's used memory (all processes: ``cuda.mem_get_info``) sampled
    every ``period`` s on a thread while the ``with`` block runs; ``peak``."""

    def __init__(self, period: float = 0.5):
        import threading

        self.period, self.peak, self._stop = period, 0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            free, total = torch.cuda.mem_get_info()
            self.peak = max(self.peak, total - free)
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10)


def byzantine_attacker_argv(phase: str, addr: str, metrics, model: str, batch_size: int, wire: str = "bf16",
                            overrides=None, extra=()) -> list:
    """The attacker's ``run_volunteer_torch.py`` command line: a Byzantine
    full-mesh volunteer of ``model`` on ``wire`` with the phase's cadence,
    group bounds and gather ceiling, peer id ``<phase>X``, seed 9; ``extra``
    adds the arm's own flags."""
    argv = [sys.executable, str(HERE / "run_volunteer_torch.py"), "--model", model,
            "--batch-size", str(batch_size),
            "--averaging", "byzantine", "--method", "trimmed_mean", "--resilience", "--wire", wire,
            "--average-every", str(PROTO_EVERY), "--no-overlap", "--min-group", "3", "--max-group", "3",
            "--gather-timeout", str(PROTO_GATHER_S),
            "--mesh-codec", "mesh", "--coordinator", addr, "--peer-id", f"{phase}X", "--seed", "9",
            "--steps", "100000", "--metrics", str(metrics)]
    for k, v in (overrides or {}).items():
        argv += ["--model-override", f"{k}={json.dumps(v)}"]
    return argv + [str(a) for a in extra]


async def byzantine_swarm(phase: str, out_dir, kw: dict, attacker_argv, scale: str, instrument, failures: list,
                          around=None) -> dict:
    """Two honest in-process volunteers of one Byzantine phase (fields
    ``kw``) and the attacker, ``attacker_argv(addr)`` run with
    ``DVC_CHAOS_CONTRIB_SCALE`` = ``scale``: starts them, waits for the
    attacker's state pull, wraps each honest volunteer with
    ``instrument(vol, i)`` (a ``ProtoRecorder``), trains until every
    recorder has ``BYZ_ROUNDS`` rounds all three fed, then stops the honest
    volunteers and sends the attacker SIGTERM (a failure if it has not
    exited 180 s later). ``around(vols)``, when given, runs before training
    and returns what runs after it; both return dicts merged into
    ``extra``."""
    import os
    import signal

    att_log = out_dir / f"{phase}_attacker.log"
    vols, paths = await start_volunteers(1, out_dir, phase, **kw)
    addr = "%s:%d" % vols[0].transport.addr
    att_metrics = out_dir / f"{phase}_attacker.jsonl"
    attacker = await asyncio.create_subprocess_exec(
        *attacker_argv(addr), cwd=str(HERE), env={**os.environ, "DVC_CHAOS_CONTRIB_SCALE": scale},
        stdout=asyncio.subprocess.PIPE, stderr=open(att_log, "w"))
    out = b""
    extra = {}
    try:
        more, more_paths = await start_volunteers(1, out_dir, phase, first=1, coordinator=addr, **kw)
        vols += more
        paths += more_paths
        deadline = time.monotonic() + PROTO_WAIT_S
        while not any(r.get("event") == "state_pull" for r in read_jsonl(att_metrics)):
            if attacker.returncode is not None or time.monotonic() > deadline:
                raise AssertionError(f"attacker not up (rc {attacker.returncode}): {att_log.read_text()[-3000:]}")
            await asyncio.sleep(0.5)
        recs = [instrument(v, i) for i, v in enumerate(vols)]
        for r in recs:
            r.done = lambda _r: min(len(x.full_rounds(3, 2)) for x in recs) >= BYZ_ROUNDS
        after = around(vols) if around else None
        cuda_sync()
        torch.cuda.reset_peak_memory_stats()
        with CardMemorySampler() as mem:
            summaries, run_s, launches = await train_until(vols, recs, phase)
        extra["card_used_peak_bytes"] = mem.peak
        extra["max_memory_allocated_this_process"] = torch.cuda.max_memory_allocated()
        if after:
            extra.update(after())
        reports = [v._build_report() for v in vols]
        policies = [v.resilience_policy.stats() for v in vols]
    finally:
        for v in vols:
            v._stop.set()
        if attacker.returncode is None:
            attacker.send_signal(signal.SIGTERM)
        await asyncio.gather(*(v.stop() for v in vols))
        try:
            out, _ = await asyncio.wait_for(attacker.communicate(), 180)
        except asyncio.TimeoutError:
            attacker.kill()
            out, _ = await attacker.communicate()
            failures.append(f"{phase}: the attacker did not exit within 180 s of SIGTERM")
    done = [ln for ln in out.decode().splitlines() if ln.startswith("VOLUNTEER_DONE ")]
    att = json.loads(done[-1].split(" ", 1)[1]) if done else None
    return {"vols": vols, "paths": paths, "recs": recs, "summaries": summaries, "run_s": run_s,
            "launches": launches, "reports": reports, "policies": policies, "att_rc": attacker.returncode,
            "att": att, "att_log": att_log, "extra": extra}


def byzantine_common(phase: str, swarm: dict, failures: list) -> dict:
    """What every Byzantine phase checks and reports of its swarm: rounds
    all three fed (at least ``BYZ_ROUNDS`` on each honest volunteer), each
    report's controller state, the attacker's exit 0 on SIGTERM and its
    codec ops on the card."""
    full = [r.full_rounds(3, 2) for r in swarm["recs"]]
    summaries, att = swarm["summaries"], swarm["att"]
    row = {"run_s": swarm["run_s"],
           "rounds_ok": [s["rounds_ok"] for s in summaries], "rounds_skipped": [s["rounds_skipped"] for s in summaries],
           "rounds_degraded": [s["rounds_degraded"] for s in summaries], "full_rounds": [len(f) for f in full],
           "round_s": [[c["s"] for c in f] for f in full],
           "policies": swarm["policies"], "controller": [rep.get("controller") for rep in swarm["reports"]],
           "attacker": {"rc": swarm["att_rc"], **{k: (att or {}).get(k) for k in ("steps", "rounds_ok", "mesh_codec")}},
           "launches": swarm["launches"],
           "card_used_peak_bytes": swarm["extra"]["card_used_peak_bytes"],
           "max_memory_allocated_this_process": swarm["extra"]["max_memory_allocated_this_process"],
           "init_memory": [v.init_memory for v in swarm["vols"]]}
    if min(len(f) for f in full) < BYZ_ROUNDS:
        failures.append(f"{phase}: rounds all three fed {row['full_rounds']} < {BYZ_ROUNDS} on each honest volunteer")
    if any(not isinstance(rep.get("controller"), dict) for rep in swarm["reports"]):
        failures.append(f"{phase}: a report lacks the controller's state")
    if swarm["att_rc"] != 0 or att is None:
        failures.append(f"{phase}: the attacker exited {swarm['att_rc']} on SIGTERM: "
                        f"{swarm['att_log'].read_text()[-3000:]}")
    att_codec = (att or {}).get("mesh_codec") or {}
    if att_codec.get("backend") != "device" or att_codec.get("ops_host") != 0 or not att_codec.get("ops_mesh"):
        failures.append(f"{phase}: the attacker's codec ops off the card: {att_codec}")
    return row


def byzantine_phase(model: str = "gpt2_small", batch_size: int = 8, phase: str = "byzantine",
                    overrides=None, param_dtype=None, lr=None) -> dict:
    """Byzantine full-mesh rounds with the trimmed mean and the resilience
    layer: two honest full-width volunteers of ``model`` in this process
    (gpt2_small, batch 8 by default) and an attacker, a
    ``run_volunteer_torch.py`` process with ``DVC_CHAOS_CONTRIB_SCALE`` =
    ``BYZ_SCALE`` (its real tree, scaled). Trim 1 of 3 is the coordinate
    median, which the attacker cannot move outside the honest pair; each
    honest policy must record rejections of the attacker, each report carry
    the controller's state. The attacker must exit 0 on SIGTERM. A model
    whose bundle averages a subtree (llama_lora: the adapters) is also held
    to it: each contribution's wire bytes are the subtree's in bf16, each
    round sends about two of them, and the rest of the params (the frozen
    base) is bit-unchanged after training on each honest volunteer."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch.swarm.transport import _payload_len

    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    attacker_id = f"{phase}X"
    (out_dir / f"{phase}_attacker.jsonl").unlink(missing_ok=True)
    rejections = [collections.Counter(), collections.Counter()]
    packs = [[], []]  # per honest volunteer: (payload elements, wire bytes) of each contribution
    sent = [[], []]  # per honest volunteer: transport bytes sent during each averaging call
    overrides = dict(overrides or {})
    kw = dict(averaging="byzantine", method="trimmed_mean", resilience=True, average_every=PROTO_EVERY,
              min_group=3, max_group=3, model=model, batch_size=batch_size, model_overrides=overrides,
              param_dtype=param_dtype, **({"lr": lr} if lr is not None else {}))
    subtree = model == "llama_lora"

    def attacker_argv(addr):
        extra = (["--param-dtype", param_dtype] if param_dtype else []) + (["--lr", lr] if lr is not None else [])
        return byzantine_attacker_argv(phase, addr, out_dir / f"{phase}_attacker.jsonl", model, batch_size,
                                       overrides=overrides, extra=extra)

    def instrument(vol, i):
        policy, avg = vol.resilience_policy, vol.averager
        record, pack = policy.record_rejection, avg._pack_and_compress

        def counted(peer):
            rejections[i][peer] += 1
            return record(peer)

        async def recorded_pack(tree):
            out = await pack(tree)
            packs[i].append((int(out[0].size), _payload_len(out[1])))
            return out

        policy.record_rejection = counted
        avg._pack_and_compress = recorded_pack
        rec = ProtoRecorder(vol)
        sent_before = [0]

        def before():
            sent_before[0] = vol.transport.bytes_sent

        def after(call, result):
            call["bytes_sent"] = vol.transport.bytes_sent - sent_before[0]
            sent[i].append(call["bytes_sent"])

        rec.before, rec.after = before, after
        return rec

    def frozen(vol):
        """The params outside the averaged subtree (llama_lora: the base)."""
        return vol.trainer.state.params["base"]

    def around(vols):
        before = [bits_fingerprint(frozen(v)) for v in vols]
        return lambda: {"base_before": before, "base_after": [bits_fingerprint(frozen(v)) for v in vols]}

    swarm = asyncio.run(byzantine_swarm(phase, out_dir, kw, attacker_argv, BYZ_SCALE, instrument, failures,
                                        around if subtree else None))
    vols, recs, launches, extra = swarm["vols"], swarm["recs"], swarm["launches"], swarm["extra"]
    full = [r.full_rounds(3, 2) for r in recs]
    row = {"phase": phase, "model": model, "overrides": overrides, "param_dtype": param_dtype,
           "batch_size": batch_size, "wire": "bf16", "method": "trimmed_mean",
           "resilience": True, "average_every": PROTO_EVERY, "gather_timeout": PROTO_GATHER_S,
           "attacker_scale": float(BYZ_SCALE), "rejections": [dict(c) for c in rejections],
           "packs": packs, "bytes_sent_per_call": sent}
    row.update(byzantine_common(phase, swarm, failures))
    row.update(proto_checks(phase, vols, swarm["summaries"], swarm["paths"], launches, failures, model, overrides))
    row["steps_per_s"] = [n / swarm["run_s"] for n in row["steps_run"]]
    if any(c[attacker_id] < 1 for c in rejections):
        failures.append(f"{phase}: an honest policy recorded no rejection of the attacker: {row['rejections']}")
    # K4 per honest volunteer per round: the health probe's slice, one lazy
    # encode per push to each of the two peers, and its own round trip.
    k4_check(phase, launches, 4 * sum(len(f) for f in full), failures)
    if subtree:
        from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

        trainer = vols[0].trainer
        n_sub = sum(int(x.numel()) for x in tree_leaves(trainer.bundle.avg_select(trainer.state.params)))
        row["averaged_params"] = n_sub
        row["frozen_params"] = sum(int(x.numel()) for x in tree_leaves(frozen(vols[0])))
        row["base_unchanged"] = [a == b for a, b in zip(extra["base_before"], extra["base_after"])]
        wire = 2 * n_sub  # bf16
        if not all(p == (n_sub, wire) for ps in packs for p in ps) or not all(packs):
            failures.append(f"{phase}: contributions are not the averaged subtree's {n_sub} elements "
                            f"in {wire} wire bytes: {packs}")
        # Two pushes of one contribution each per round, plus framing and
        # the round's small RPCs: nowhere near the frozen params' size.
        sent_full = [[c["bytes_sent"] for c in f] for f in full]
        row["bytes_sent_per_full_round"] = sent_full
        if not all(2 * wire <= b <= 3 * wire + (4 << 20) for ss in sent_full for b in ss):
            failures.append(f"{phase}: bytes sent per full round outside [2, 3] contributions: {sent_full}")
        if not all(row["base_unchanged"]):
            failures.append(f"{phase}: the frozen base changed in training: {row['base_unchanged']}")
        # Each leaf cast as it is made: the init's peak above what it left
        # resident is one stacked layer and a top-level leaf in f32, never
        # the whole model in f32.
        for v in vols:
            m = v.init_memory
            if m["peak_bytes"] > m["resident_bytes"] + (2 << 30):
                failures.append(f"{phase}: init peak {m} holds more than 2 GiB above the resident params")
    by_epoch = collections.defaultdict(dict)
    for i, r in enumerate(recs):
        for b in r.buffers:
            if b["size"] == 3 and not b["degraded"] and not b["outcomes"].get("absent"):
                by_epoch[b["epoch"]][i] = b
    values = []
    for epoch, got in by_epoch.items():
        if len(got) < 2:
            continue
        x0, x1 = got[0]["payload"], got[1]["payload"]
        widen = AVG_TOL["bf16_u"] * np.maximum(np.abs(x0), np.abs(x1)) + AVG_TOL["floor"]
        lo, hi = np.minimum(x0, x1) - widen, np.maximum(x0, x1) + widen
        for i in (0, 1):
            res = got[i]["result"]
            v = {"epoch": epoch, "volunteer": i, "step": got[i]["step"],
                 "outside_max": float(np.maximum(lo - res, res - hi).max()), "finite": bool(np.isfinite(res).all()),
                 "honest_results_bit_equal": got[0]["result"].tobytes() == got[1]["result"].tobytes()}
            values.append(v)
            # Both honest volunteers aggregate the same three wire-rounded
            # contributions: a result left unchanged, or one that missed a
            # contribution, differs from the other's.
            if not (v["finite"] and v["outside_max"] <= 0.0 and v["honest_results_bit_equal"]):
                failures.append(f"{phase}: honest result outside the honest pair or unlike the other's: {v}")
    if not values:
        failures.append(f"{phase}: no round with both honest results recorded")
    row["values"] = values
    emit(row)
    if failures:
        raise AssertionError(f"{phase} phase: {failures}")
    return launches


def median_of_three(stack):
    """The coordinate median of a [3, n] stack, elementwise: what trim 1 of
    3 keeps, computed apart from the codec's estimator."""
    import numpy as np

    a, b, c = stack
    return np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))


def rows_d2(stack, agg, chunk: int = 1 << 24) -> list:
    """Each row's squared distance to ``agg`` in float64, a chunk at a time
    (apart from ``health.row_d2``)."""
    import numpy as np

    out = [0.0] * len(stack)
    for lo in range(0, agg.size, chunk):
        ref = agg[lo:lo + chunk].astype(np.float64)
        for i, row in enumerate(stack):
            d = row[lo:lo + chunk] - ref
            out[i] += float(d @ d)
    return out


def compressed_byzantine_phase(phase: str, wire: str, psgd_rank=None) -> dict:
    """Config 8's grads-mode Byzantine arms (``experiments/run_matrix.py``
    ``config8_kitchen_sink_r4``) at full width: two honest gpt2_small
    volunteers (at ``DEPTH_CUT``) in this process and the attacker process at
    ``BYZ_GRADS_SCALE`` (-3), the trimmed mean with trim ``BYZ_GRADS_TRIM``
    (1), a round every step on ``wire`` ("powersgd" at ``psgd_rank``, or
    "sign").

    Each honest volunteer runs its averager on a codec of its own (the
    process codec's device and backend), so the device low-rank calls that
    codec counts (``MeshCodec.low_rank_calls``, counted where the device op
    runs) are that volunteer's. Volunteer 0's codec keeps the estimator's
    input of each round all three fed (the last ``BYZ_ROUNDS`` + 1): the
    three decoded rows (honest, honest, attacker: peer ids sort so) and the
    aggregate. After the run the phase checks, apart from the averager's own
    code: the aggregate equals the
    coordinate median of the rows bit for bit (so each honest result lies
    inside the honest pair); the rows past the reference's rejection bar
    (squared distance to the aggregate above ``ATTACKER_BAR`` times the
    median row distance squared, in float64) are exactly the peers each
    honest policy rejected in that round; both honest results are bit-equal
    and equal the recorded aggregate. K4 and K5 must not launch, and on
    powersgd each honest codec's low-rank ops must have run on the card and
    the two codecs' counts must add up to the process's. The attacker must
    exit 0 on SIGTERM.

    Per round the row reports the attacker's ratio to the bar's median, the
    attacker's RMS over the honest mean (k) and the honest rows' cosine.
    With honest sign rows that agree in sign no more than chance, the ratio
    is k² − k + 1 in expectation, under 9 unless k passes about 3.37: a ×−3
    attacker is rejected only when its gradient is larger than the honest
    ones, as when its round still carries the gradient of an earlier step
    (PERF.md section 7), so a rejection in every run is reported
    (``attacker_rejected_rounds``), not required."""
    import hashlib

    import numpy as np

    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.swarm.transport import _payload_len
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    attacker_id = f"{phase}X"
    (out_dir / f"{phase}_attacker.jsonl").unlink(missing_ok=True)
    rejections = [collections.Counter(), collections.Counter()]
    packs = [[], []]  # per honest volunteer: (payload elements, wire bytes) of each contribution
    codecs = [None, None]
    pending = [None]  # volunteer 0: the estimator input (stack, aggregate) of its current round
    kept = []  # volunteer 0: the epochs whose input is still held
    results = collections.defaultdict(dict)  # epoch -> volunteer -> sha256 of its result
    kw = dict(averaging="byzantine", method="trimmed_mean", method_kw={"trim": BYZ_GRADS_TRIM}, resilience=True,
              average_every=PROTO_EVERY, min_group=3, max_group=3, wire=wire, average_what="grads",
              model_overrides=dict(DEPTH_CUT), **({"powersgd_rank": psgd_rank} if psgd_rank is not None else {}))
    flags = ["--average-what", "grads", "--method-kw", f"trim={BYZ_GRADS_TRIM}"]
    flags += ["--psgd-rank", psgd_rank] if psgd_rank is not None else []

    def attacker_argv(addr):
        return byzantine_attacker_argv(phase, addr, out_dir / f"{phase}_attacker.jsonl", "gpt2_small", 8,
                                       wire=wire, overrides=DEPTH_CUT, extra=flags)

    def digest(buf) -> str:
        return hashlib.sha256(np.ascontiguousarray(buf, np.float32).view(np.uint8)).hexdigest()

    def recording(codec):
        aggregate = codec.aggregate

        def recorded(stack, method, **kwargs):
            # Kept, not analysed: host work here would slow this volunteer's
            # rounds against the other's (they share one interpreter).
            out = aggregate(stack, method, **kwargs)
            if len(stack) == 3:
                pending[0] = (stack, out)
            return out

        return recorded

    def analyse(stack, out) -> dict:
        """The estimator's input of one round against the rule, in float64."""
        med = median_of_three(stack)
        d2 = rows_d2(stack, med)
        sq = [float(np.einsum("i,i->", r, r, dtype=np.float64)) for r in stack]
        rms = [math.sqrt(x / stack.shape[1]) for x in sq]
        bar = float(np.median(np.sqrt(d2))) ** 2
        return {"aggregate_is_median": bool(np.array_equal(out, med)), "aggregate": digest(out), "d2": d2,
                "rms": rms, "past_bar": [i for i in range(3) if bar > 0 and d2[i] > ATTACKER_BAR * bar],
                "ratio": d2[2] / bar if bar > 0 else None, "k": rms[2] / (0.5 * (rms[0] + rms[1])),
                "honest_cos": float(np.einsum("i,i->", stack[0], stack[1], dtype=np.float64)) / math.sqrt(sq[0] * sq[1])}

    def instrument(vol, i):
        policy, avg = vol.resilience_policy, vol.averager
        record, pack = policy.record_rejection, avg._pack_and_compress
        codecs[i] = mc.MeshCodec(device=avg.mesh_codec.device, backend=avg.mesh_codec.backend)
        if i == 0:
            codecs[i].aggregate = recording(codecs[i])
        avg._mesh_codec = codecs[i]

        def counted(peer):
            rejections[i][peer] += 1
            return record(peer)

        async def recorded_pack(tree):
            out = await pack(tree)
            packs[i].append((int(out[0].size), _payload_len(out[1])))
            return out

        policy.record_rejection = counted
        avg._pack_and_compress = recorded_pack
        rec = ProtoRecorder(vol, keep=0)
        before_counts = [None]

        def before():
            before_counts[0] = collections.Counter(rejections[i])
            pending[0] = None if i == 0 else pending[0]

        def after(call, result):
            call["rejected"] = sorted((rejections[i] - before_counts[0]).elements())
            if result is not None and call["size"] == 3 and not call["degraded"] \
                    and not call["outcomes"].get("absent"):
                results[call["epoch"]][i] = {"digest": digest(flatten_to_buffer(result)[0]), "step": call["step"],
                                             "rejected": call["rejected"],
                                             **({"input": pending[0]} if i == 0 else {})}
                if i == 0:
                    kept.append(call["epoch"])
                    if len(kept) > BYZ_ROUNDS + 1:  # host memory: 2 GB a round
                        results[kept.pop(0)][0].pop("input", None)

        rec.before, rec.after = before, after
        return rec

    swarm = asyncio.run(byzantine_swarm(phase, out_dir, kw, attacker_argv, BYZ_GRADS_SCALE, instrument, failures))
    vols, launches = swarm["vols"], swarm["launches"]
    row = {"phase": phase, "model": "gpt2_small", "overrides": DEPTH_CUT, "batch_size": 8, "wire": wire,
           "average_what": "grads",
           "method": "trimmed_mean", "method_kw": {"trim": BYZ_GRADS_TRIM}, "powersgd_rank": psgd_rank,
           "resilience": True, "average_every": PROTO_EVERY, "gather_timeout": PROTO_GATHER_S,
           "attacker_scale": float(BYZ_GRADS_SCALE), "attacker_bar": ATTACKER_BAR,
           "rejections": [dict(c) for c in rejections], "packs": packs}
    row.update(byzantine_common(phase, swarm, failures))
    row.update(proto_checks(phase, vols, swarm["summaries"], swarm["paths"], launches, failures, "gpt2_small",
                            DEPTH_CUT))
    row["steps_per_s"] = [n / swarm["run_s"] for n in row["steps_run"]]
    rounds = []
    peers = [v.cfg.peer_id for v in vols] + [attacker_id]
    for epoch, got in results.items():
        if len(got) < 2 or "input" not in got[0]:
            continue
        rec = got[0].pop("input")
        rec = analyse(*rec) if rec is not None else None
        r = {"epoch": epoch, "step": got[0]["step"], "rejected": [got[0]["rejected"], got[1]["rejected"]],
             "results_bit_equal": got[0]["digest"] == got[1]["digest"]}
        if rec is not None:
            r.update({k: rec[k] for k in ("ratio", "k", "honest_cos", "rms", "d2", "aggregate_is_median")})
            r["past_bar"] = [peers[i] for i in rec["past_bar"]]
            r["result_is_aggregate"] = got[0]["digest"] == rec["aggregate"]
        rounds.append(r)
        # The estimator, the rule and the policies, apart from the
        # averager's own arithmetic: one round's checks.
        if rec is None or not (r["aggregate_is_median"] and r["result_is_aggregate"] and r["results_bit_equal"]) \
                or any(rj != [p for p in r["past_bar"] if p != peers[i]] for i, rj in enumerate(r["rejected"])):
            failures.append(f"{phase}: a round's aggregate, results or rejections disagree with the rule: {r}")
    row["rounds"] = rounds
    row["attacker_rejected_rounds"] = [sum(attacker_id in r["rejected"][i] for r in rounds) for i in (0, 1)]
    if len(rounds) < BYZ_ROUNDS:
        failures.append(f"{phase}: {len(rounds)} rounds recorded on both honest volunteers < {BYZ_ROUNDS}")
    # The compressed wires encode on the host (native) and PowerSGD's
    # factors are library calls: no K4, and nothing streams into K5.
    if launches["bf16_encode"] or launches["bf16_fold_chunks"]:
        failures.append(f"{phase}: K4/K5 launched on the {wire} wire: {launches}")
    row["low_rank_calls"] = [dict(c.low_rank_calls) for c in codecs]
    row["codec_stats"] = [c.stats() for c in codecs]
    if wire == "powersgd":
        total = {k: sum(c.low_rank_calls[k] for c in codecs) for k in mc.LOW_RANK_CALLS}
        if not all(c.low_rank_calls[k] > 0 for c in codecs for k in total) or total != dict(mc.LOW_RANK_CALLS):
            failures.append(f"{phase}: an honest volunteer's PowerSGD ops did not run on its card codec, or the "
                            f"codecs' counts {row['low_rank_calls']} miss the process's {dict(mc.LOW_RANK_CALLS)}")
    att_calls = ((swarm["att"] or {}).get("mesh_codec") or {}).get("launches", {})
    row["attacker"]["low_rank_calls"] = {k: att_calls.get(k) for k in mc.LOW_RANK_CALLS}
    emit(row)
    if failures:
        raise AssertionError(f"{phase} phase: {failures}")
    return launches


# ---------------------------------------------------------------------------
# the model zoo: capability configs 1, 2, 3 and 5, and the ViT
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the volunteer under faults and on a zoned schedule: zoned group rounds,
# a sync leader's death across processes, hedged tile recovery
# ---------------------------------------------------------------------------

ZONES = ("a", "a", "b", "b")  # the zones phase's volunteers, in peer-id order
ZONE_GROUP = 2  # group_size
ZONE_K = 2  # cross_zone_every_k: even rotations cross zones, odd ones stay inside
ZONE_ROTATION_S = 10.0  # group_rotation_s: four rotations fit in ~40 s
# Committed rounds of each level each volunteer must make; a cross round
# counts when its group spans both zones (the cross grid is zone-blind: a
# hashed group can also land inside one zone, or hold all four).
ZONE_COMMITS = {"intra": 2, "cross": 1}
ZONE_GATHER_S = 30.0  # gather ceiling: a scheduled member that never joins costs this much
# On an intra round no averaging byte crosses a zone; a volunteer's other
# traffic (heartbeats, DHT stores) still does. The bound on all of it during
# such a round is far under one payload (249 MB at full width).
ZONE_CTRL_BYTES = 1 << 20
FAIL_EVERY = 2  # the failover phase's averaging cadence (steps)
FAIL_WAIT_S = 300.0  # cap on each wait of the failover phase
FAIL_PHASE = "mid_stream"  # where the leader dies: after part of the stream folded on K5
HEDGE_BUDGET_S = 12.0  # the hedge phase's static round deadline
HEDGE_LATE = 2.0  # the straggler's push would land this many budgets late (a thin link)
HEDGE_WEIGHTS = (1.0, 2.0, 3.0)  # leader, member, straggler


def _sync_bytes_counter(vol, zone_of, counts) -> None:
    """Wrap ``vol``'s transport so the request and reply payload bytes of its
    ``sync.*`` calls add to ``counts[peer]["intra" | "cross"]`` by the
    destination's zone (each averaging byte is counted once, at its
    sender's call)."""
    from distributedvolunteercomputing_tpu_torch.swarm.transport import _payload_len

    pid, t, mem = vol.cfg.peer_id, vol.transport, vol.membership
    call = t.call

    async def counting(addr, method, args=None, payload=b"", *a, **kw):
        out = await call(addr, method, args, payload, *a, **kw)
        if method.startswith("sync."):
            z = mem.zone_by_addr().get((str(addr[0]), int(addr[1])))
            reply = out[1] if isinstance(out, tuple) and len(out) == 2 else b""
            side = "intra" if z == zone_of[pid] else "cross"
            counts[pid][side] += _payload_len(payload) + _payload_len(reply or b"")
        return out

    t.call = counting


def zones_phase() -> dict:
    """Four full-width volunteers in two zones (``ZONES``) on the zoned group
    schedule: groups of ``ZONE_GROUP``, rotations every ``ZONE_ROTATION_S``
    on the wall clock, every ``ZONE_K``-th rotation across zones, blocking
    bf16 sync rounds every ``AVG_EVERY`` steps, the device codec. Until each
    has committed ``ZONE_COMMITS`` rounds of each level (cross: groups that
    span both zones). Checked: intra groups of two inside one zone, with no
    ``sync.*`` byte across zones and ``zone_traffic()``'s cross-zone bytes
    under ``ZONE_CTRL_BYTES``; a recorded round of each level whose whole
    group committed within ``AVG_TOL`` (leader against the weighted mean of
    the group's payloads, members against the leader); K1-K3 per step; K4
    and K5 at the counts the rounds imply."""
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    zone_of = {f"zones{i}": z for i, z in enumerate(ZONES)}
    sync_bytes = {pid: {"intra": 0, "cross": 0} for pid in zone_of}
    # level -> the last two committed calls (cross: zone-spanning), with payload and result
    kept = {pid: {lv: collections.deque(maxlen=2) for lv in ZONE_COMMITS} for pid in zone_of}

    def committed(rec, level):
        """Committed rounds of ``level`` (cross: those spanning both zones)."""
        return [c for c in rec.calls if c["ok"] and c["level"] == level
                and (level != "cross" or len(c["zones"]) == 2)]

    def instrument(vol):
        pid, avg = vol.cfg.peer_id, vol.averager
        _sync_bytes_counter(vol, zone_of, sync_bytes)
        rec = ProtoRecorder(vol, keep=0)
        mark = {}

        def before():
            mark["sync"] = dict(sync_bytes[pid])
            mark["zt"] = avg.zone_traffic()

        def after(c, result):
            zt = avg.zone_traffic()
            c["sync_bytes"] = {k: sync_bytes[pid][k] - mark["sync"][k] for k in ("intra", "cross")}
            c["zone_traffic_cross"] = sum(zt[f"cross_zone_bytes_{d}"] - mark["zt"][f"cross_zone_bytes_{d}"]
                                          for d in ("sent", "received"))
            c["zones"] = sorted({zone_of.get(m, "?") for m in c["members"]})
            c["leader"] = c["members"][0] if c["members"] else None
            if result is not None and c["level"] in ZONE_COMMITS and (c["level"] != "cross" or len(c["zones"]) == 2):
                kept[pid][c["level"]].append({**c, "payload": flatten_to_buffer(rec.last_params)[0],
                                              "result": flatten_to_buffer(result)[0]})

        rec.before, rec.after = before, after
        return rec

    async def run():
        vols, paths = await start_volunteers(
            len(ZONES), out_dir, "zones", averaging="sync", average_every=AVG_EVERY, join_timeout=4.0,
            gather_timeout=ZONE_GATHER_S, model_overrides=dict(DEPTH_CUT),
            group_size=ZONE_GROUP, group_rotation_s=ZONE_ROTATION_S, cross_zone_every_k=ZONE_K,
            per=lambda i: {"zone": ZONES[i]},
        )
        try:
            recs = [instrument(v) for v in vols]
            for r in recs:
                r.done = lambda _r: all(len(committed(x, lv)) >= n for x in recs for lv, n in ZONE_COMMITS.items())
            out = await train_until(vols, recs, "zones")
            return (vols, paths, recs, *out, [v.averager.zone_traffic() for v in vols])
        finally:
            await asyncio.gather(*(v.stop() for v in vols))

    vols, paths, recs, summaries, run_s, launches, traffic = asyncio.run(run())
    pids = list(zone_of)
    calls = {pid: r.calls for pid, r in zip(pids, recs)}
    agg = [s.get("aggregation", {}) for s in summaries]
    row = {"phase": "zones", "model": "gpt2_small", "overrides": DEPTH_CUT, "batch_size": 8, "wire": "bf16",
           "zones": zone_of,
           "group_size": ZONE_GROUP, "group_rotation_s": ZONE_ROTATION_S, "cross_zone_every_k": ZONE_K,
           "average_every": AVG_EVERY, "run_s": run_s,
           "committed": {pid: {lv: len(committed(r, lv)) for lv in ZONE_COMMITS} for pid, r in zip(pids, recs)},
           "committed_by_size": {pid: dict(collections.Counter(f"{c['level']}:{c['size']}:{'+'.join(c['zones'])}"
                                                                for c in r.calls if c["ok"])) for pid, r in zip(pids, recs)},
           "gather_timeout": ZONE_GATHER_S, "hedge": [s.get("hedge") for s in summaries],
           "rounds_skipped": [s["rounds_skipped"] for s in summaries],
           "round_s": {lv: [c["s"] for r in recs for c in committed(r, lv)] for lv in ZONE_COMMITS},
           "calls": {pid: [{k: c[k] for k in ("step", "ok", "s", "weight", "group_id", "level", "members",
                                              "sync_bytes", "zone_traffic_cross")} for c in cs]
                     for pid, cs in calls.items()},
           "zone_traffic": traffic,
           "aggregation": agg, "launches": launches}
    row.update(proto_checks("zones", vols, summaries, paths, launches, failures, "gpt2_small", DEPTH_CUT))
    for pid, r in zip(pids, recs):
        for lv, n in ZONE_COMMITS.items():
            if len(committed(r, lv)) < n:
                failures.append(f"zones: {pid} committed {len(committed(r, lv))} {lv} rounds < {n}")
        for c in r.calls:
            if not c["ok"]:
                continue
            if c["level"] == "intra" and not (len(c["zones"]) == 1 and c["sync_bytes"]["cross"] == 0
                                              and c["zone_traffic_cross"] < ZONE_CTRL_BYTES):
                failures.append(f"zones: {pid}'s intra round left its zone: {c['group_id']} {c['members']} "
                                f"sync {c['sync_bytes']} zone_traffic cross {c['zone_traffic_cross']}")
            if c["level"] == "intra" and c["size"] != ZONE_GROUP:
                failures.append(f"zones: {pid} committed an intra round of {c['size']} ({c['group_id']})")
            if c["level"] not in ("intra", "cross"):
                failures.append(f"zones: {pid} committed a {c['level']} round ({c['group_id']}) on the zoned grid")
    # K4: each formed group packs twice (health probe, whole buffer), and each
    # member's fetch of a committed round reads the leader's lazy result
    # stream, which encodes the result once per fetch. K5: one launch per
    # flush of each leader's staged folder.
    fetched = sum(1 for pid, r in zip(pids, recs) for c in r.calls if c["ok"] and c["leader"] != pid)
    expect = {"bf16_encode": 2 * sum(r.groups for r in recs) + fetched,
              "bf16_fold_chunks": sum(a.get("folder_flushes", 0) for a in agg)}
    row["codec_launches_expected"] = expect
    if sum(a.get("aborted_contribs", 0) + a.get("tiles_recovered", 0) + a.get("hedge_duplicates", 0)
           for a in agg):
        failures.append("zones: aborted or hedged contributions: the launch counts would not be exact")
    if {k: launches[k] for k in expect} != expect or not expect["bf16_fold_chunks"]:
        failures.append(f"zones: codec launches {[launches[k] for k in expect]} != expected {expect}")
    values, seen = [], set()
    for lv in ZONE_COMMITS:
        for rec in [r for pid in pids for r in kept[pid][lv]]:
            epoch = rec["epoch"]
            group = {pid: next((r for r in kept[pid][lv] if r["epoch"] == epoch), None) for pid in rec["members"]}
            if epoch in seen or any(r is None for r in group.values()):
                continue
            seen.add(epoch)
            values.append({"level": lv, "group_id": rec["group_id"], **group_values(group, rec["members"][0], failures)})
    if {v["level"] for v in values} != set(ZONE_COMMITS):
        failures.append(f"zones: rounds whose whole group was recorded, by level: {[v['level'] for v in values]}")
    row["values"] = values
    cross = [c["zone_traffic_cross"] for r in recs for c in committed(r, "cross")]
    row["xz_bytes_per_committed_cross_round"] = CROSS_ZONE_BYTES["zones"] = (
        float(sum(cross) / len(cross)) if cross else None)
    del kept
    emit(row)
    if failures:
        raise AssertionError(f"zones phase: {failures}")
    return launches


def failover_phase() -> dict:
    """A sync leader SIGKILLed mid-round across processes: a
    ``coordinator_torch.py`` process and three ``run_volunteer_torch.py``
    processes, gpt2_small at full width, blocking bf16 sync rounds every
    ``FAIL_EVERY`` steps. ``a0`` starts first with ``--min-group 3`` and
    ``DVC_CHAOS_LEADER_DIE_PHASE`` = ``FAIL_PHASE``; ``b1`` and ``c2`` then
    start together with ``--min-group 2``. Until ``a0``'s first round, no
    bulk transfer has run, so no volunteer advertises an uplink and the
    smallest id, ``a0``, leads (the survivors first would have averaged
    alone, advertised their measured uplinks, and out-ranked a newcomer
    with none: ``Matchmaker._pick_leader``); ``a0``'s rendezvous record
    keeps the survivors waiting for its begin until all three have joined.
    Checked: ``a0`` exits by SIGKILL; the survivors commit no round before
    it dies and at least two after (the recovered round and one more),
    then exit 0 on SIGTERM; each deposed ``a0``, one recovered the round;
    their codec stats: device backend, no host op, K4 launches, K5 launches
    equal to their folders' flushes and some K5 launch; K1-K3 per step."""
    import os
    import shutil
    import signal
    import tempfile

    (HERE / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="failover_", dir=HERE / "build"))
    procs, files, failures = {}, [], []
    paths = {k: tmp / f"{k}.jsonl" for k in ("a0", "b1", "c2")}

    def spawn(name, argv, env=None):
        out, err = open(tmp / f"{name}.out", "w"), open(tmp / f"{name}.log", "w")
        files.extend((out, err))
        procs[name] = subprocess.Popen([sys.executable, *map(str, argv)], cwd=str(HERE), env=env,
                                       stdout=out, stderr=err)
        return procs[name]

    def tail(name, n=3000) -> str:
        p = tmp / f"{name}.log"
        return p.read_text()[-n:] if p.exists() else ""

    def wait_for(what, cond, alive=()):
        deadline = time.monotonic() + FAIL_WAIT_S
        while not cond():
            for name in alive:
                if procs[name].poll() is not None:
                    raise AssertionError(f"failover: {name} exited ({procs[name].returncode}) waiting for "
                                         f"{what}: {tail(name)}")
            if time.monotonic() > deadline:
                raise AssertionError(f"failover: timed out waiting for {what}")
            time.sleep(0.5)

    def ok_rounds(name) -> int:
        return committed_rounds(read_jsonl(paths[name]))

    def volunteer(name, seed, min_group, env):
        return spawn(name, [HERE / "run_volunteer_torch.py", "--model", "gpt2_small", "--batch-size", "8",
                            "--averaging", "sync", "--wire", "bf16", "--mesh-codec", "mesh",
                            "--average-every", FAIL_EVERY, "--no-overlap",
                            "--min-group", min_group, "--coordinator", addr, "--metrics", paths[name],
                            "--peer-id", name, "--seed", seed, "--steps", 100000], env=env)

    t0 = time.perf_counter()
    summaries, timeline = {}, {}
    try:
        spawn("coord", [HERE / "coordinator_torch.py", "--port", "0"])
        ready = tmp / "coord.out"
        wait_for("the coordinator", lambda: "COORDINATOR_READY" in ready.read_text(), alive=("coord",))
        addr = ready.read_text().split("COORDINATOR_READY", 1)[1].split()[0]
        release_card_memory()  # three processes share the card with this one
        volunteer("a0", 1, 3, {**os.environ, "DVC_CHAOS_LEADER_DIE_PHASE": FAIL_PHASE})
        # a0 has trained past its first cadence point: its rendezvous record is up.
        wait_for("a0's first steps", lambda: len([r for r in read_jsonl(paths["a0"]) if "loss" in r]) >= FAIL_EVERY,
                 alive=("a0",))
        timeline["a0_ready_s"] = time.perf_counter() - t0
        for name, seed in (("b1", 2), ("c2", 3)):
            volunteer(name, seed, 2, dict(os.environ))
        wait_for("a0's death", lambda: procs["a0"].poll() is not None, alive=("b1", "c2"))
        timeline["a0_dead_s"] = time.perf_counter() - t0
        before = {n: ok_rounds(n) for n in ("b1", "c2")}
        wait_for("two committed rounds on each survivor", lambda: all(ok_rounds(n) >= 2 for n in ("b1", "c2")),
                 alive=("b1", "c2"))
        timeline["survivors_two_rounds_s"] = time.perf_counter() - t0
        for n in ("b1", "c2"):
            procs[n].send_signal(signal.SIGTERM)
        for n in ("b1", "c2"):
            try:
                procs[n].wait(timeout=180)
            except subprocess.TimeoutExpired:
                failures.append(f"failover: {n} did not exit within 180 s of SIGTERM")
                procs[n].kill()
            text = (tmp / f"{n}.out").read_text()
            done = [ln for ln in text.splitlines() if ln.startswith("VOLUNTEER_DONE ")]
            summaries[n] = json.loads(done[-1][len("VOLUNTEER_DONE "):]) if done else {}
        timeline["survivors_exited_s"] = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        logs = {n: tail(n, 1500) for n in ("a0", "b1", "c2")}
        # Steps each trained (its loss records): a survivor that pulled a0's
        # state starts counting from a0's step.
        trained = {n: len([r for r in read_jsonl(paths[n]) if "loss" in r]) for n in ("b1", "c2")}
        shutil.rmtree(tmp, ignore_errors=True)

    per_step = flash_per_step("gpt2_small")
    row = {"phase": "failover", "model": "gpt2_small", "batch_size": 8, "wire": "bf16", "every": FAIL_EVERY,
           "die_phase": FAIL_PHASE, "timeline_s": timeline, "a0_returncode": procs["a0"].returncode,
           "returncodes": {n: procs[n].returncode for n in ("b1", "c2")}, "rounds_before_death": before,
           "survivors": {}}
    launches = {k: 0 for k in (*KERNELS, *CODEC_KERNELS)}
    if procs["a0"].returncode != -signal.SIGKILL:
        failures.append(f"failover: a0 exited {procs['a0'].returncode}, want -SIGKILL: {logs['a0']}")
    recovered = 0
    for n in ("b1", "c2"):
        s = summaries.get(n) or {}
        fo, codec, agg = s.get("failover") or {}, s.get("mesh_codec") or {}, s.get("aggregation") or {}
        k = codec.get("launches") or {}
        flash = s.get("flash_launches") or {}
        steps = trained[n]
        row["survivors"][n] = {"rounds_ok": s.get("rounds_ok"), "rounds_skipped": s.get("rounds_skipped"),
                               "steps_trained": steps, "final_step": s.get("steps"), "failover": fo, "mesh_codec": codec, "flash_launches": flash,
                               "folder_flushes": agg.get("folder_flushes", 0), "final_loss": s.get("final_loss")}
        recovered += fo.get("rounds_recovered", 0)
        for kname, count in {**k, **flash}.items():
            launches[kname] = launches.get(kname, 0) + count
        if procs[n].returncode != 0 or not s:
            failures.append(f"failover: {n} exited {procs[n].returncode} without its summary: {logs[n]}")
            continue
        if before[n] > 1 or s.get("rounds_ok", 0) < 2:
            failures.append(f"failover: {n} committed {before[n]} rounds before a0 died and "
                            f"{s.get('rounds_ok')} in all (want <= 1 and >= 2)")
        if fo.get("leaders_deposed", 0) < 1:
            failures.append(f"failover: {n} never deposed a0: {fo}")
        if codec.get("backend") != "device" or codec.get("ops_host", 1) != 0 or k.get("bf16_encode", 0) < 1:
            failures.append(f"failover: {n}'s codec off the device path: {codec}")
        if k.get("bf16_fold_chunks", 0) != agg.get("folder_flushes", 0):
            failures.append(f"failover: {n}'s K5 launches {k} != its folder's {agg.get('folder_flushes')} flushes")
        want = {kn: c * steps for kn, c in zip(KERNELS, per_step)}
        if {kn: flash.get(kn) for kn in KERNELS} != want:
            failures.append(f"failover: {n}'s K1-K3 launches {flash} != {want} for {steps} steps")
    if recovered < 1:
        failures.append("failover: no survivor recovered the killed round")
    if not launches.get("bf16_fold_chunks"):
        failures.append("failover: no survivor folded on K5 (the recovery's successor must)")
    row["launches"] = launches
    emit(row)
    if failures:
        raise AssertionError(f"failover phase: {failures}")
    return launches


def hedge_phase() -> dict:
    """Hedged tile recovery at the averager level at full width: a leader and
    two members (``SyncAverager``s on ``ChaosTransport``s, bf16 wire, the
    device codec), each contributing a gpt2_small-sized flat f32 buffer (the
    model's init plus each one's own noise: 124,439,808 floats, 249 MB on
    the wire), weights ``HEDGE_WEIGHTS``, a static round deadline of
    ``HEDGE_BUDGET_S``. The straggler's link to the leader is thin: its push
    would land ``HEDGE_LATE`` budgets late (``set_link``; a refetch request
    is meta-sized and its reply rides the unshaped return path). With
    ``hedge=True`` the leader re-requests the straggler's tiles past its
    soft deadline and folds them on K5: at least one hedge issued, the slot
    recovered, the result within ``AVG_TOL`` of the weighted mean of all
    three payloads (a tile folded twice, or one missed, would be far off).
    With ``hedge=False`` the round commits at the deadline over the other
    two, within ``AVG_TOL`` of their weighted mean. Each arm's round
    seconds, lost mass (the share of contribution slots not committed) and
    K4/K5 launches are printed; K5's equal the leader folder's flushes."""
    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
    from distributedvolunteercomputing_tpu_torch.swarm.chaos import ChaosTransport
    from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
    from distributedvolunteercomputing_tpu_torch.swarm.matchmaking import Group
    from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

    release_card_memory()
    codec = mc.configure(backend="device")
    dev = codec.device
    gen = torch.Generator(device=dev).manual_seed(0)
    base = torch.from_numpy(flatten_to_buffer(get_model("gpt2_small").init(gen))[0]).to(dev)
    payloads = []
    for i in range(3):
        noise = torch.randn(base.numel(), generator=gen, device=dev)
        payloads.append((base + 1e-3 * noise).cpu().numpy())
        del noise
    n = payloads[0].size
    failures = []

    async def arm(hedge: bool) -> dict:
        nodes = []
        for pid in ("leader", "m0", "m1"):
            t = ChaosTransport(seed=len(nodes))
            dht = DHTNode(t)
            nodes.append((pid, t, SyncAverager(t, dht, SwarmMembership(dht, pid, ttl=30.0), wire="bf16",
                                               mesh_codec=codec, method="mean", min_group=2,
                                               gather_timeout=HEDGE_BUDGET_S + 10.0, hedge=hedge)))
            await t.start()
        (_, lt, leader), (_, _, m0), (_, st, m1) = nodes
        link_bw = (n * 2) / (HEDGE_LATE * HEDGE_BUDGET_S)
        st.set_link(lt.addr, st.addr, bw_bps=link_bw)
        tokens = {pid: f"tok-{pid}" for pid, _, _ in nodes}
        members = [(pid, t.addr) for pid, t, _ in nodes]
        epoch = f"hedge-{int(hedge)}"

        def group(i):
            return Group(epoch=epoch, members=list(members), my_index=i, token=tokens[members[i][0]],
                         member_tokens=tokens if i == 0 else None, deadline=time.time() + HEDGE_BUDGET_S,
                         budget=HEDGE_BUDGET_S)

        try:
            bufs = [avg._pack({"w": payloads[i]}) for i, (_, _, avg) in enumerate(nodes)]
            cuda_sync()
            reset_all_launch_counts()
            t0 = time.perf_counter()
            lead = asyncio.create_task(leader._lead_round(group(0), bufs[0], HEDGE_WEIGHTS[0]))
            await asyncio.sleep(0.15)  # the leader has armed

            async def push(i):
                pid, t, avg = nodes[i]
                mgroup = group(i)
                avg._retain_push(mgroup, bufs[i], HEDGE_WEIGHTS[i])  # what average() retains for sync.refetch
                wire = await asyncio.to_thread(avg._wire_stream, bufs[i])
                return await t.call(lt.addr, "sync.contribute",
                                    {"epoch": epoch, "peer": pid, "weight": HEDGE_WEIGHTS[i], "schema": leader._schema,
                                     "token": tokens[pid]}, wire, timeout=HEDGE_LATE * HEDGE_BUDGET_S + 30.0)

            pushes = [asyncio.create_task(push(i)) for i in (1, 2)]
            result = await asyncio.wait_for(lead, timeout=HEDGE_BUDGET_S + 60.0)
            round_s = time.perf_counter() - t0
            cuda_sync()
            launches = dict(mc.LAUNCHES)
            for p in pushes:
                if not p.done():
                    p.cancel()
            outcomes = await asyncio.gather(*pushes, return_exceptions=True)
            mass = leader.health._last_mass if leader.health else None
            return {"hedge": hedge, "round_s": round_s, "result": flatten_to_buffer(result)[0] if result else None,
                    "mass": mass, "hedges_issued": leader.hedges_issued, "hedges_failed": leader.hedges_failed,
                    "slots_recovered": leader.slots_recovered, "gauges": dict(leader._agg_gauges),
                    "launches": launches, "straggler_link_bps": link_bw,
                    "pushes": [type(o).__name__ if isinstance(o, BaseException) else "ok" for o in outcomes]}
        finally:
            ChaosTransport._links.clear()
            for _, t, _ in nodes:
                await t.close()

    def value_check(res, which) -> dict:
        xs = [torch.from_numpy(payloads[i]).to(dev, torch.float64) for i in which]
        ws = [HEDGE_WEIGHTS[i] for i in which]
        want = sum(w * x for w, x in zip(ws, xs)) / sum(ws)
        scale = torch.stack([x.abs() for x in xs]).amax(0)
        got = torch.from_numpy(res["result"]).to(dev, torch.float64)
        err = (got - want).abs()
        lim = (AVG_TOL["bf16_u"] + AVG_TOL["f32_ulps"]) * scale + AVG_TOL["floor"]
        out = {"over": list(which), "weights": ws, "max_abs_err": err.max().item(),
               "limit_used": (err / lim).max().item(), "finite": bool(torch.isfinite(got).all())}
        del xs, want, scale, got, err, lim
        return out

    arms = {}
    for hedge in (True, False):
        res = asyncio.run(arm(hedge))
        mass = res["mass"] or {}
        row = {k: v for k, v in res.items() if k != "result"}
        # Lost mass in slots: a straggler whose push never arrived has no
        # known weight, so its loss shows in the slots, not the weights.
        row["lost_slots_frac"] = 1.0 - mass["slot_committed_frac"] if mass else None
        if res["result"] is None:
            failures.append(f"hedge={hedge}: the round did not commit: {row}")
        else:
            row["values"] = value_check(res, (0, 1, 2) if hedge else (0, 1))
            if not (row["values"]["finite"] and row["values"]["limit_used"] <= 1.0):
                failures.append(f"hedge={hedge}: result outside AVG_TOL: {row['values']}")
        if res["launches"]["bf16_fold_chunks"] != res["gauges"].get("folder_flushes") or \
                not res["launches"]["bf16_fold_chunks"]:
            failures.append(f"hedge={hedge}: K5 launches {res['launches']} != the folder's flushes {res['gauges']}")
        arms["hedged" if hedge else "drop"] = row
        del res
    h, d = arms["hedged"], arms["drop"]
    if h["hedges_issued"] < 1 or h["slots_recovered"] < 1:
        failures.append(f"hedged arm: {h['hedges_issued']} hedges, {h['slots_recovered']} slots recovered")
    if d["hedges_issued"] or d["slots_recovered"]:
        failures.append(f"drop arm hedged: {d['hedges_issued']} hedges")
    # The straggler re-encodes each refetched range on its codec: K4.
    if h["launches"]["bf16_encode"] < d["launches"]["bf16_encode"] + 1:
        failures.append(f"hedged arm: no K4 launch for the refetch: {h['launches']} vs drop {d['launches']}")
    row = {"phase": "hedge", "n": n, "wire": "bf16", "budget_s": HEDGE_BUDGET_S, "weights": HEDGE_WEIGHTS,
           "arms": arms, "launches": {k: h["launches"][k] + d["launches"][k] for k in h["launches"]}}
    emit(row)
    del payloads, base
    release_card_memory()
    if failures:
        raise AssertionError(f"hedge phase: {failures}")
    return row["launches"]


# ---------------------------------------------------------------------------
# the compressed wires and zone-sharded training: q8 and topk sync rounds,
# config 8's PowerSGD and sign Byzantine arms, a zone-sharded swarm
# ---------------------------------------------------------------------------

WIRE_ARMS = {  # arm -> the two volunteers' config fields
    "q8": dict(wire="q8", average_every=AVG_EVERY),
    "topk": dict(wire="topk", average_what="grads", topk_frac=0.01, average_every=1),
}
WIRE_COMMITS = 2  # committed rounds each volunteer of an arm must make
WIRE_GATHER_S = 20.0  # gather ceiling of the wires arms: a round takes 3-7 s, a skipped one this long
# The wires' own rounding. A leader's result is an f32 fold of the
# contributions as peers decode them: 4 f32 ulps of their scale. A q8
# member's is the leader's result through q8: one quantization step of its
# chunk (the chunk's largest magnitude / 127; the native codec's stated
# bound). A topk member's is exact (a result ships every nonzero), held to
# the same 4 ulps.
WIRE_TOL = {"f32_ulps": 4 * 2.0**-24, "q8_steps": 1.0, "floor": 2.0**-126}
PSGD_RANK = 4  # config 8's --psgd-rank
# The reference's rejection rule (ByzantineAverager): a row is voted out when
# its squared distance to the robust aggregate passes 9 times the median row
# distance squared (3x in distance).
ATTACKER_BAR = 9.0
BYZ_GRADS_SCALE = "-3"  # config 8's attacker (DVC_CHAOS_CONTRIB_SCALE)
BYZ_GRADS_TRIM = 1  # config 8's --method-kw trim=1
SHARD_K = 2  # zone_shards
SHARD_ZONES = ("a", "a", "b", "b")  # the zone_shards phase's volunteers
# group_rotation_s: every rotation groups the same pairs (each shard's
# holders across the zones), so a long one only spares rounds the skips at
# rotation boundaries.
SHARD_ROTATION_S = 30.0
SHARD_COMMITS = 2  # committed rounds each volunteer must make before one leaves
SHARD_SETTLE_S = 90.0  # cap on the wait for each zone's holders to agree on one map
SHARD_RECOVER_S = 120.0  # cap on the wait for the partner's re-shard and recovery
# Cross-zone bytes per committed cross round of the zones phase, for the
# zone_shards phase's row.
CROSS_ZONE_BYTES: dict = {}


def wire_contribution_bytes(wire: str, n: int, frac=None) -> int:
    """The wire bytes of one contribution of ``n`` elements."""
    from distributedvolunteercomputing_tpu_torch import native

    if wire == "q8":
        return native.q8_coded_size(n)
    if wire == "sign":
        return native.sign_coded_size(n)
    # topk: magic, mode and n; then a u32 index and an f32 value per entry.
    return 3 + 1 + 8 + 8 * max(1, int(n * frac))


def wire_pair_values(pair: dict, leader: str, wire: str, failures: list) -> dict:
    """One committed round of a wires arm: ``pair`` maps each volunteer to its
    record (weight, ``sent``: its contribution as peers decode it, result).
    The leader's result against the f64 weighted mean of the decoded
    contributions, the member's against the leader's (``WIRE_TOL``); f64 on
    the card."""
    from distributedvolunteercomputing_tpu_torch import native

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    tol = WIRE_TOL
    xs = {pid: torch.from_numpy(r["sent"]).to(dev, torch.float64) for pid, r in pair.items()}
    ws = {pid: r["weight"] for pid, r in pair.items()}
    want = sum(ws[p] * xs[p] for p in xs) / sum(ws.values())
    scale = torch.stack(list(xs.values())).abs().amax(0)
    del xs
    lead = torch.from_numpy(pair[leader]["result"]).to(dev, torch.float64)
    err = (lead - want).abs()
    out = {"members": list(pair), "leader": leader, "weights": ws, "step": pair[leader]["step"],
           "leader_max_abs_err": err.max().item(),
           "leader_limit_used": (err / (tol["f32_ulps"] * scale + tol["floor"])).max().item(),
           "member_limit_used": 0.0, "finite": bool(torch.isfinite(lead).all())}
    del want, scale, err
    lim = tol["f32_ulps"] * lead.abs() + tol["floor"]
    if wire == "q8":
        n, chunk = lead.numel(), native.Q8_CHUNK
        cmax = torch.nn.functional.pad(lead.abs(), (0, -n % chunk)).view(-1, chunk).amax(1)
        lim = lim + tol["q8_steps"] * cmax.repeat_interleave(chunk)[:n] / 127.0
        del cmax
    for pid, r in pair.items():
        if pid != leader:
            got = torch.from_numpy(r["result"]).to(dev, torch.float64)
            out["member_limit_used"] = max(out["member_limit_used"], ((got - lead).abs() / lim).max().item())
            out["member_bit_equal"] = r["result"].tobytes() == pair[leader]["result"].tobytes()
            out["finite"] &= bool(torch.isfinite(got).all())
            del got
    del lead, lim
    if not (out["finite"] and out["leader_limit_used"] <= 1.0 and out["member_limit_used"] <= 1.0):
        failures.append(f"{wire}: averaged values outside WIRE_TOL: {out}")
    return out


def wires_phase() -> dict:
    """The q8 and topk wires (``WIRE_ARMS``), two full-width volunteers per
    arm (gpt2_small at ``DEPTH_CUT``) in blocking sync rounds: q8 averages params every ``AVG_EVERY``
    steps, topk (``topk_frac`` 0.01) gradients every step. Until each
    volunteer has committed ``WIRE_COMMITS`` rounds. Checked per arm: every
    contribution's wire bytes are ``wire_contribution_bytes`` of the
    averaged subtree's element count; each round both recorded within
    ``WIRE_TOL`` (``wire_pair_values``); on topk the error-feedback residual
    of each volunteer's last contribution equals ``x -
    topk_decode(topk_encode(x))`` bit for bit (x: the gradient plus the
    banked residual) and is what a committed round banks; K1-K3 per step;
    no K4 and no K5 (these wires encode on the host, and only f32 and bf16
    stream into the device folder)."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch import native
    from distributedvolunteercomputing_tpu_torch.swarm.transport import _payload_len
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer, tree_leaves

    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    launches_by_arm = {}
    for arm, fields in WIRE_ARMS.items():
        what = f"wires_{arm}"
        wire, frac = fields["wire"], fields.get("topk_frac")
        failures = []
        packs, kept, ef, banked = {}, {}, {}, {}

        def instrument(vol):
            pid, avg = vol.cfg.peer_id, vol.averager
            packs[pid], kept[pid], banked[pid] = [], collections.deque(maxlen=3), []
            pack, average = avg._pack_and_compress, avg.average
            cur = {}

            async def recorded_pack(tree):
                prev = avg._ef_residual
                out = await pack(tree)
                packs[pid].append((int(out[0].size), _payload_len(out[1])))
                cur["wire"] = out[1]  # decoded after training, off the loop
                if wire == "topk":
                    ef[pid] = (out[0], prev, avg._ef_pending)
                return out

            async def weighed(tree, *a, **kw):
                cur["weight"] = kw.get("weight", 1.0)
                return await average(tree, *a, **kw)

            avg._pack_and_compress, avg.average = recorded_pack, weighed
            rec = ProtoRecorder(vol, keep=0)

            def before():
                cur.clear()

            def after(call, result):
                if result is None or "wire" not in cur:
                    return
                if wire == "topk":
                    banked[pid].append(avg._ef_residual is ef[pid][2])
                kept[pid].append({"epoch": call["epoch"], "step": call["step"], "members": call["members"],
                                  "weight": cur["weight"], "wire": cur["wire"],
                                  "result": flatten_to_buffer(result)[0]})

            rec.before, rec.after = before, after
            return rec

        async def run():
            vols, paths = await start_volunteers(2, out_dir, what, averaging="sync", join_timeout=4.0,
                                                 gather_timeout=WIRE_GATHER_S, model_overrides=dict(DEPTH_CUT),
                                                 **fields)
            try:
                recs = [instrument(v) for v in vols]
                for r in recs:
                    r.done = lambda _r: min(x.committed() for x in recs) >= WIRE_COMMITS
                out = await train_until(vols, recs, what)
                trainer = vols[0].trainer
                n = sum(int(x.numel()) for x in tree_leaves(trainer.bundle.avg_select(trainer.state.params)))
                return (vols, paths, recs, *out, n)
            finally:
                await asyncio.gather(*(v.stop() for v in vols))

        vols, paths, recs, summaries, run_s, launches, n = asyncio.run(run())
        pids = [v.cfg.peer_id for v in vols]
        want_bytes = wire_contribution_bytes(wire, n, frac)
        row = {"phase": "wires", "arm": arm, "model": "gpt2_small", "overrides": DEPTH_CUT, "batch_size": 8,
               **fields, "run_s": run_s,
               "n": n, "contribution_bytes_expected": want_bytes,
               "contribution_bytes": {pid: sorted({b for _, b in packs[pid]}) for pid in pids},
               "committed": [r.committed() for r in recs],
               "rounds_skipped": [s["rounds_skipped"] for s in summaries],
               "round_s": [[c["s"] for c in r.calls if c["ok"]] for r in recs],
               "wan_bytes_sent": [s["wan_bytes_sent"] for s in summaries], "launches": launches}
        row.update(proto_checks(what, vols, summaries, paths, launches, failures, "gpt2_small", DEPTH_CUT,
                                codec_ops=False))
        if min(row["committed"]) < WIRE_COMMITS:
            failures.append(f"{what}: committed {row['committed']} < {WIRE_COMMITS} each")
        for pid in pids:
            if not packs[pid] or any(p != (n, want_bytes) for p in packs[pid]):
                failures.append(f"{what}: {pid}'s contributions are not {n} elements in {want_bytes} bytes: "
                                f"{sorted(set(packs[pid]))}")
        if launches["bf16_encode"] or launches["bf16_fold_chunks"]:
            failures.append(f"{what}: K4/K5 launched on the {wire} wire: {launches}")
        values = []
        common = sorted({r["epoch"] for r in kept[pids[0]]} & {r["epoch"] for r in kept[pids[1]]})
        for epoch in common:
            pair = {pid: next(r for r in kept[pid] if r["epoch"] == epoch) for pid in pids}
            for r in pair.values():
                r["sent"] = (native.q8_decode(r["wire"]) if wire == "q8"
                             else native.topk_decode(bytes(r["wire"]), max_floats=n))
            leader = pair[pids[0]]["members"][0]
            values.append(wire_pair_values(pair, leader, wire, failures))
        if len(values) < WIRE_COMMITS:
            failures.append(f"{what}: values of {len(values)} rounds recorded on both, want >= {WIRE_COMMITS}")
        row["values"] = values
        if wire == "topk":
            row["ef"] = {}
            for pid in pids:
                buf, prev, pending = ef[pid]
                x = buf + prev if prev is not None and prev.size == buf.size else buf
                want = x - native.topk_decode(native.topk_encode(x, frac=frac), max_floats=x.size)
                row["ef"][pid] = {"residual_bit_equal": pending.tobytes() == want.tobytes(),
                                  "had_residual": prev is not None, "banked_on_commit": banked[pid]}
                if not (row["ef"][pid]["residual_bit_equal"] and all(banked[pid]) and banked[pid]):
                    failures.append(f"{what}: {pid}'s error-feedback residual: {row['ef'][pid]}")
                del buf, prev, pending, x, want
        del kept, ef
        emit(row)
        if failures:
            raise AssertionError(f"{what} phase: {failures}")
        launches_by_arm[what] = launches
        release_card_memory()
    return launches_by_arm


def shard_peer_ids(namespace: str) -> list:
    """Peer ids for ``SHARD_ZONES`` whose HRW maps give each zone's two
    holders one shard each (HRW gives two members no balance guarantee; the
    reference's chaos soak picks its holders the same way)."""
    from distributedvolunteercomputing_tpu_torch.swarm.sharding import ShardMap

    out = []
    for zone in dict.fromkeys(SHARD_ZONES):
        for t in range(4000):
            a, b = f"shard{zone}{t:03d}x", f"shard{zone}{t:03d}y"
            m = ShardMap(members=(a, b), k=SHARD_K, gen=0, domain=f"{zone}|{namespace}")
            if m.shards_of(a) == [0] and m.shards_of(b) == [1]:
                out += [a, b]
                break
        else:
            raise AssertionError(f"no balanced holder pair for zone {zone}")
    return out


def zone_shards_phase() -> dict:
    """Zone-sharded training at full width (gpt2_small at ``DEPTH_CUT``):
    four volunteers in this process
    in zones ``SHARD_ZONES`` with ``zone_shards`` = ``SHARD_K``, groups of 2,
    every rotation across zones (``cross_zone_every_k`` 1, rotations every
    ``SHARD_ROTATION_S``), blocking bf16 sync rounds every ``AVG_EVERY``
    steps. Once each zone's holders agree on one map, they train until each
    has committed ``SHARD_COMMITS`` rounds. Checked while all four are up:
    both holders of a zone hold the same ``ShardMap`` fence and each owns
    its HRW shard, advertised in its membership record; every committed
    round's group id carries the ``.s<k>.`` segment of its members' shared
    shard; each such round within ``AVG_TOL``; K1-K3 per step; K4 and K5 at
    the counts the rounds imply. Then the zone-a holder of shard 0 stops
    gracefully: its partner re-shards, records ``shard_recovered`` (source
    and latency) and ends with no shard missing. Finally each survivor's
    ``save_shard_snapshot``, and ``assemble_full`` of zone b's two equal bit
    for bit to their held slices; cross-zone bytes per committed round
    (``zone_traffic()``) beside the zones phase's."""
    import re
    import shutil

    import numpy as np

    from distributedvolunteercomputing_tpu_torch.training.checkpoint import assemble_full, save_shard_snapshot
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

    out_dir = HERE / "build" / "chip_smoke"
    snap_root = out_dir / "zone_shards_snapshots"
    shutil.rmtree(snap_root, ignore_errors=True)
    failures = []
    ids = shard_peer_ids("gpt2_small/params")
    zone_of = dict(zip(ids, SHARD_ZONES))
    kept = {pid: collections.deque(maxlen=2) for pid in ids}

    def instrument(vol):
        pid, avg = vol.cfg.peer_id, vol.averager
        rec = ProtoRecorder(vol, keep=0)
        mark = {}

        def before():
            mark["zt"] = avg.zone_traffic()

        def after(c, result):
            zt = avg.zone_traffic()
            c["zone_traffic_cross"] = sum(zt[f"cross_zone_bytes_{d}"] - mark["zt"][f"cross_zone_bytes_{d}"]
                                          for d in ("sent", "received"))
            c["zones"] = sorted({zone_of.get(m, "?") for m in c["members"]})
            # The shard this volunteer advertises as the round ends (a peer's
            # cached view of it may lag by a heartbeat).
            c["advertised"] = vol.membership.extra_info.get("shard")
            if result is not None:
                kept[pid].append({**c, "payload": flatten_to_buffer(rec.last_params)[0],
                                  "result": flatten_to_buffer(result)[0]})

        rec.before, rec.after = before, after
        return rec

    async def maps_agree(vols) -> bool:
        """Each zone's two holders on one map, and every volunteer's
        membership snapshot showing each holder's primary shard."""
        for z in dict.fromkeys(SHARD_ZONES):
            sms = [v.shard_manager for v in vols if zone_of[v.cfg.peer_id] == z]
            if any(sm.map is None or len(sm.map.members) != 2 for sm in sms) or \
                    len({sm.map.fence for sm in sms}) != 1:
                return False
        primary = {v.cfg.peer_id: v.shard_manager.primary_shard() for v in vols}
        for v in vols:
            peers = await v.membership.alive_peers()
            if any((peers.get(m) or {}).get("shard") != s for m, s in primary.items()):
                return False
        return True

    async def run():
        vols, paths = await start_volunteers(
            len(ids), out_dir, "zone_shards", averaging="sync", average_every=AVG_EVERY, join_timeout=4.0,
            gather_timeout=ZONE_GATHER_S, group_size=2, group_rotation_s=SHARD_ROTATION_S, cross_zone_every_k=1,
            zone_shards=SHARD_K, model_overrides=dict(DEPTH_CUT),
            per=lambda i: {"zone": SHARD_ZONES[i], "peer_id": ids[i]},
        )
        extra, left = {}, []
        try:
            t0 = time.perf_counter()
            while not await maps_agree(vols):
                if time.perf_counter() - t0 > SHARD_SETTLE_S:
                    raise AssertionError("zone_shards: maps did not settle: " + json.dumps(
                        {v.cfg.peer_id: v.shard_manager.summary() for v in vols}, default=str))
                await asyncio.sleep(0.5)
            extra["settle_s"] = time.perf_counter() - t0
            recs = [instrument(v) for v in vols]
            for r in recs:
                r.done = lambda _r: min(x.committed() for x in recs) >= SHARD_COMMITS
            summaries, run_s, launches = await train_until(vols, recs, "zone_shards")
            # Checked while all four are up (training stopped, the swarm services run).
            extra["maps"] = {v.cfg.peer_id: {"fence": v.shard_manager.map.fence, "gen": v.shard_manager.map.gen,
                                             "owned": v.shard_manager.owned(),
                                             "hrw": v.shard_manager.map.shards_of(v.cfg.peer_id),
                                             "advertised": v.membership.extra_info.get("shard")} for v in vols}
            extra["zone_traffic"] = [v.averager.zone_traffic() for v in vols]
            # One holder of zone a leaves gracefully; its partner takes over.
            leaver, partner = vols[0], vols[1]
            left.append(leaver)
            await leaver.stop()
            sm = partner.shard_manager
            gen0, t0 = sm.map.gen, time.perf_counter()
            while not (sm.map.gen > gen0 and sm.owned() == list(range(SHARD_K)) and not sm.missing()
                       and sm.recoveries >= 1):
                if time.perf_counter() - t0 > SHARD_RECOVER_S:
                    raise AssertionError(f"zone_shards: {partner.cfg.peer_id} did not take over: {sm.summary()}")
                await asyncio.sleep(0.5)
            extra["takeover_s"] = time.perf_counter() - t0
            extra["recovered_events"] = partner.telemetry.recorder.dump(kinds=["shard_recovered"])
            extra["partner_summary"] = sm.summary()
            survivors = vols[1:]
            step = int(partner.trainer.state.step)
            extra["snapshots"] = {v.cfg.peer_id: save_shard_snapshot(
                str(snap_root / v.cfg.peer_id), v.shard_manager.store, v.shard_manager.map, step) for v in survivors}
            zone_b = [v for v in survivors if zone_of[v.cfg.peer_id] == "b"]
            full = assemble_full([extra["snapshots"][v.cfg.peer_id] for v in zone_b], zone_b[0].shard_manager.n_elems,
                                 SHARD_K)
            extra["assembled_bit_equal"] = {
                v.cfg.peer_id: all(full[lo:hi].tobytes() == v.shard_manager.store.get(s, allow_replica=False).tobytes()
                                   for s in v.shard_manager.owned()
                                   for lo, hi in [v.shard_manager.ranges[s]]) for v in zone_b}
            extra["assembled_elems"] = int(full.size)
            del full
            extra["summaries_sharding"] = {v.cfg.peer_id: v._build_report().get("sharding") for v in survivors}
            return vols, paths, recs, summaries, run_s, launches, extra
        finally:
            await asyncio.gather(*(v.stop() for v in vols if v not in left))
            shutil.rmtree(snap_root, ignore_errors=True)

    vols, paths, recs, summaries, run_s, launches, extra = asyncio.run(run())
    agg = [s.get("aggregation", {}) for s in summaries]
    committed_calls = {pid: [c for c in r.calls if c["ok"]] for pid, r in zip(ids, recs)}
    row = {"phase": "zone_shards", "model": "gpt2_small", "overrides": DEPTH_CUT, "batch_size": 8, "wire": "bf16",
           "zones": zone_of,
           "zone_shards": SHARD_K, "group_size": 2, "cross_zone_every_k": 1, "group_rotation_s": SHARD_ROTATION_S,
           "average_every": AVG_EVERY, "run_s": run_s, **extra,
           "committed": {pid: len(cs) for pid, cs in committed_calls.items()},
           "rounds_skipped": [s["rounds_skipped"] for s in summaries],
           "round_s": [c["s"] for cs in committed_calls.values() for c in cs],
           "calls": {pid: [{k: c[k] for k in ("step", "ok", "s", "group_id", "level", "members", "zone_traffic_cross",
                                              "advertised")}
                           for c in r.calls] for pid, r in zip(ids, recs)},
           "aggregation": agg, "launches": launches}
    row.update(proto_checks("zone_shards", vols, summaries, paths, launches, failures, "gpt2_small", DEPTH_CUT))
    for z in dict.fromkeys(SHARD_ZONES):
        fences = {extra["maps"][pid]["fence"] for pid in ids if zone_of[pid] == z}
        if len(fences) != 1:
            failures.append(f"zone_shards: zone {z}'s holders hold different fences: {fences}")
    for pid in ids:
        m = extra["maps"][pid]
        if not (m["owned"] == m["hrw"] and len(m["owned"]) == 1 and m["advertised"] == m["owned"][0]):
            failures.append(f"zone_shards: {pid} does not own and advertise its one HRW shard: {m}")
    advertised = {(pid, c["group_id"]): c["advertised"] for pid, cs in committed_calls.items() for c in cs}
    for pid, cs in committed_calls.items():
        if len(cs) < SHARD_COMMITS:
            failures.append(f"zone_shards: {pid} committed {len(cs)} rounds < {SHARD_COMMITS}")
        for c in cs:
            seg = re.search(r"\.s(\d+)\.", c["group_id"] or "")
            shard = int(seg.group(1)) if seg else None
            # What each member advertised as it committed this group's round.
            adv = {m: advertised.get((m, c["group_id"])) for m in c["members"]}
            if shard is None or shard != extra["maps"][pid]["owned"][0] or set(adv.values()) != {shard}:
                failures.append(f"zone_shards: {pid}'s round {c['group_id']} members advertise {adv}")
    fetched = sum(1 for pid, cs in committed_calls.items() for c in cs if c["members"] and c["members"][0] != pid)
    expect = {"bf16_encode": 2 * sum(r.groups for r in recs) + fetched,
              "bf16_fold_chunks": sum(a.get("folder_flushes", 0) for a in agg)}
    row["codec_launches_expected"] = expect
    if sum(a.get("aborted_contribs", 0) + a.get("tiles_recovered", 0) + a.get("hedge_duplicates", 0) for a in agg):
        failures.append("zone_shards: aborted or hedged contributions: the launch counts would not be exact")
    if {k: launches[k] for k in expect} != expect:
        failures.append(f"zone_shards: codec launches {[launches[k] for k in expect]} != expected {expect}")
    values, seen = [], set()
    for pid in ids:
        for rec in kept[pid]:
            group = {m: next((r for r in kept[m] if r["epoch"] == rec["epoch"]), None) for m in rec["members"]}
            if rec["epoch"] in seen or any(r is None for r in group.values()):
                continue
            seen.add(rec["epoch"])
            values.append({"group_id": rec["group_id"], **group_values(group, rec["members"][0], failures)})
    if not values:
        failures.append("zone_shards: no round whose whole group was recorded")
    row["values"] = values
    events = extra["recovered_events"]
    if not events or any(e.get("src") is None or e.get("dt_s") is None for e in events):
        failures.append(f"zone_shards: no shard_recovered event with a source and latency: {events}")
    if not extra["assembled_bit_equal"] or not all(extra["assembled_bit_equal"].values()):
        failures.append(f"zone_shards: zone b's assembled snapshots differ from the held slices: "
                        f"{extra['assembled_bit_equal']}")
    cross = [c["zone_traffic_cross"] for cs in committed_calls.values() for c in cs]
    row["xz_bytes_per_committed_round"] = float(np.mean(cross)) if cross else None
    row["xz_bytes_per_committed_cross_round_zones_phase"] = CROSS_ZONE_BYTES.get("zones")
    del kept
    emit(row)
    if failures:
        raise AssertionError(f"zone_shards phase: {failures}")
    return launches


VIT_BATCH = 32  # the entry script's default batch
VIT_STEPS = 8  # the first 2 warm up; samples/s is read over the rest
# The reference's capability-config rows (experiments/run_matrix.py) at the
# registry's widths: model, batch, lr, cadence.
MNIST_ARGV = ["--averaging", "none", "--steps", "300", "--batch-size", "32", "--lr", "0.01", "--target-loss", "0.15"]
RESNET = dict(model="cifar10_resnet18", batch_size=16, every=10, lr=0.005)
BERT = dict(model="bert_mlm", n=4, batch_size=16, lr=0.003)
LLAMA = dict(model="llama_lora", batch_size=1, lr=0.005, param_dtype="bfloat16")
# K1-K3 on the models' main paths: model -> (shape [B, H, T, D], causal,
# the layout the model hands the kernels: head-split views of a fused qkv,
# or Llama's contiguous rotated q and k).
MODEL_ATTENTION = {
    # gpt2_small's attention on one of two tp ranks (mesh_step): its head
    # group of 6, the q/k/v column slices of the rank's qkv part.
    "gpt2_small_tp2": ((4, 6, 1024, 64), True, "qkv"),
    "bert_mlm": ((BERT["batch_size"], 12, 512, 64), False, "qkv"),
    "cifar10_vit": ((VIT_BATCH, 3, 65, 64), False, "qkv"),
    "llama_lora": ((LLAMA["batch_size"], 32, 4096, 128), True, "contiguous"),
}


def llama2_7b() -> dict:
    """``LlamaConfig.llama2_7b()`` as registry overrides: the published widths and depth."""
    from distributedvolunteercomputing_tpu_torch.models.llama import LlamaConfig

    return dataclasses.asdict(LlamaConfig.llama2_7b())


def model_kernels_phase(fa, peak) -> dict:
    """K1-K3 against their plain versions at each model's main-path shape
    (in the model's layout and contiguous), then timed there beside SDPA
    and the bound, as at the flagship shape."""
    out = {}
    for model, (shape, causal, layout) in MODEL_ATTENTION.items():
        checks = check_kernels(fa, shape, torch.bfloat16, causal, peak, layout=layout)
        if layout != "contiguous":
            check_kernels(fa, shape, torch.bfloat16, causal, peak)
        times = time_attention(fa, peak, shape=shape, causal=causal, layouts=("contiguous",))["contiguous"]
        out[model] = {"shape": list(shape), "causal": causal, "checks": checks, "times": times}
    return out


def vit_phase() -> dict:
    """cifar10_vit at its registry config, one volunteer, no averaging,
    ``VIT_STEPS`` steps at batch ``VIT_BATCH``: finite losses and K1-K3 at
    ``flash_per_step`` (24 / 12 / 12 per step); samples/s after the first two
    steps (``steady_samples_per_sec``, from the metrics' timestamps)."""
    from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig

    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "vit_volunteer.jsonl"
    path.unlink(missing_ok=True)
    failures = []

    async def run():
        release_card_memory()
        vol = Volunteer(VolunteerConfig(model="cifar10_vit", batch_size=VIT_BATCH, averaging="none",
                                        steps=VIT_STEPS, metrics_path=str(path), peer_id="vit0"))
        await vol.start()
        try:
            cuda_sync()
            reset_all_launch_counts()
            t0 = time.perf_counter()
            summary = await vol.train()
            cuda_sync()
            return summary, time.perf_counter() - t0, proto_launches()
        finally:
            await vol.stop()

    summary, run_s, launches = asyncio.run(run())
    row = {"phase": "vit", "model": "cifar10_vit", "batch_size": VIT_BATCH, "run_s": run_s,
           "samples_per_sec": summary.get("samples_per_sec"), "launches": launches}
    records = [r for r in read_jsonl(path) if "loss" in r]
    losses, ts = [r["loss"] for r in records], [r["t"] for r in records]
    if len(ts) > 2:
        row["steady_samples_per_sec"] = (len(ts) - 2) * VIT_BATCH / (ts[-1] - ts[1])
    k1, k2, k3 = flash_per_step("cifar10_vit")
    expect = {"flash_fwd": k1 * len(losses), "flash_dq": k2 * len(losses), "flash_dkv": k3 * len(losses)}
    row.update(losses=losses, launches_expected=expect)
    if len(losses) != VIT_STEPS or not all(math.isfinite(x) for x in losses):
        failures.append(f"vit: missing or non-finite losses {losses}")
    if {k: launches[k] for k in expect} != expect:
        failures.append(f"vit: K1-K3 launches {launches} != {expect}")
    emit(row)
    if failures:
        raise AssertionError(f"vit phase: {failures}")
    return launches


def mnist_phase() -> dict:
    """Capability config 1 through the entry script's default model:
    ``run_volunteer_torch.py`` with no ``--model`` (mnist_mlp) and config
    1's flags; it must exit 0 having crossed the target loss."""
    from distributedvolunteercomputing_tpu_torch.models import common, get_model

    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics = out_dir / "mnist_volunteer.jsonl"
    metrics.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(HERE / "run_volunteer_torch.py"), *MNIST_ARGV, "--metrics",
                           str(metrics)], cwd=str(HERE), capture_output=True, text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("VOLUNTEER_DONE ")]
    summary = json.loads(done[-1].split(" ", 1)[1]) if done else {}
    row = {"phase": "mnist", "argv": MNIST_ARGV, "rc": proc.returncode, "wall_s": wall_s,
           "params": common.count_params(get_model("mnist_mlp").init(torch.Generator())),
           **{k: summary.get(k) for k in ("steps", "final_loss", "target_crossed_step", "target_crossed_s",
                                          "samples_per_sec", "wall_time_s")}}
    emit(row)
    if proc.returncode != 0 or row["target_crossed_step"] is None:
        raise AssertionError(f"mnist phase: rc {proc.returncode}, summary {summary}: {proc.stderr[-3000:]}")
    return row


# ---------------------------------------------------------------------------
# ring: K6 / K7 against their plain versions, the DP trainer, the ring round
# ---------------------------------------------------------------------------


def ring_ranks(nd: int):
    """The first ``nd`` visible cards when there are that many, else ``nd``
    ranks sharing cuda:0 (their ring hops are then device-local reads)."""
    n = torch.cuda.device_count()
    cross = n >= nd
    devices = [torch.device("cuda", i if cross else 0) for i in range(nd)]
    return devices, cross


def ring_case(name: str, devices, n_elems: int, tile: int, tiles, weights, gen, special: bool = False):
    """One flush of ``len(tiles)`` chunks over ``nd`` ranks: random f32
    accumulator shards, each chunk's bf16 bits (short tail chunks
    zero-padded), the chunks split over the ranks as the ring folder splits
    a batch (contiguous runs)."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc

    nd = len(devices)
    n_tiles = -(-n_elems // tile)
    shard = tile // nd
    k = len(tiles)
    x = torch.randn((k, tile), generator=gen, device="cuda")
    bits = mc.encode_bf16_plain(x.view(-1)).view(k, tile)
    if special:
        # Random bit patterns (every exponent: subnormals, inf, NaN) with the
        # special values up front in every chunk.
        bits = torch.randint(-(2**15), 2**15, (k, tile), generator=gen, device="cuda", dtype=torch.int32)
        bits = bits.to(torch.int16)
        sp = torch.from_numpy(np.array(RING_SPECIAL_BF16, np.uint16).view(np.int16)).cuda()
        bits[:, : sp.numel()] = sp
    for i, t in enumerate(tiles):
        valid = min(tile, n_elems - t * tile)
        bits[i, valid:] = 0  # a short tail chunk is zero-padded
    per = -(-k // nd)
    own = [slice(min(d * per, k), min((d + 1) * per, k)) for d in range(nd)]
    acc0 = torch.randn((n_tiles, tile), generator=gen, device="cuda")
    return {
        "name": name, "nd": nd, "n_elems": n_elems, "tile": tile, "n_tiles": n_tiles, "shard": shard,
        "devices": devices, "tiles": list(tiles), "weights": list(weights), "special": special,
        "bits_full": bits,
        "bits": [bits[sl].to(dev).contiguous() for sl, dev in zip(own, devices)],
        "rank_tiles": [list(tiles[sl]) for sl in own],
        "rank_weights": [list(weights[sl]) for sl in own],
        "acc0": acc0,
    }


def ring_accs(case):
    sh = case["shard"]
    return [case["acc0"][:, d * sh : (d + 1) * sh].to(dev).contiguous() for d, dev in enumerate(case["devices"])]


def bits_equal(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Bit-equal on every lane where ``want`` is finite; inf lanes equal and
    NaN lanes NaN on both sides."""
    got, want = got.to(want.device), want
    fin = torch.isfinite(want)
    diff_bits = (got.view(torch.int32) != want.view(torch.int32)) & fin
    nonfin_ok = ((got == want) | (torch.isnan(got) & torch.isnan(want)))[~fin].all().item()
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    return {"finite_lanes_differing": int(diff_bits.sum().item()), "nonfinite_lanes": int((~fin).sum().item()),
            "nonfinite_match": bool(nonfin_ok), "max_abs_err": err}


def host_fold(case, accs_init) -> "np.ndarray":
    """``native``'s host fold of the flush, in batch order, into the
    initial accumulator (the reference's ``_host_ref``)."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch import native

    full = torch.cat([a.cpu() for a in accs_init], dim=1).numpy().reshape(-1).copy()
    bits = case["bits_full"].cpu().numpy().view(np.uint16)
    tile = case["tile"]
    for i, (t, w) in enumerate(zip(case["tiles"], case["weights"])):
        n = min(tile, case["n_elems"] - t * tile)
        native.weighted_sum_inplace(full[t * tile : t * tile + n], native.bf16_to_f32(bits[i, :n]), w)
    return full[: case["n_elems"]]


def k6_launch_groups(devices) -> int:
    """K6 launch groups: one per card, at most ``K6_MAX_RANKS`` ranks each.
    One group is the one-card design (one launch per ring); more, the
    stepwise design (one launch per group per ring step)."""
    return sum(-(-n // K6_MAX_RANKS) for n in collections.Counter(str(d) for d in devices).values())


def k6_rings(rank_tiles, nd: int) -> int:
    """The rings K6 folds a flush in, from its metadata words: a ring of U
    slots and K chunks takes U·(1 + nd) + nd + 2K words (row and slot_ptr per
    slot, the closing slot_ptr, chunk and weight per chunk); the distinct
    tiles, sorted, go into one ring while it stays within
    ``K6_META_WORDS``."""
    counts = collections.Counter(t for ts in rank_tiles for t in ts)
    rings, words = 1, nd
    for t in sorted(counts):
        w = 1 + nd + 2 * counts[t]
        if words + w > K6_META_WORDS:
            rings, words = rings + 1, nd
        words += w
    return rings


def ring_launches(devices, rings: int, stepwise: bool = False) -> tuple:
    """(K6 launches for a flush of ``rings`` rings, K7 launches per result)
    on the ranks ``devices``, by the design the wrappers pick there, or by
    the stepwise design (``ring_fold_stepwise`` / ``ring_allgather_stepwise``)
    where ``stepwise``."""
    nd, groups = len(devices), k6_launch_groups(devices)
    if groups == 1 and not stepwise:
        return rings, 1
    return nd * groups * rings, nd * (nd - 1)


def ring_kernels_phase(peak, ranks=ring_ranks) -> dict:
    """K6 and K7 against ``ring_fold_plain`` / ``ring_allgather_plain`` at
    nd = 2 and 4 on the ranks of ``ring_ranks``: the flagship geometry (one
    full 16-chunk flush with repeated tiles, the short tail tile and one zero
    weight), a ragged one (tile not a multiple of 8 per shard: the scalar
    paths; a short tail chunk) and special bit patterns. K6 bit-equal on
    finite lanes with inf/NaN lanes matching, K7 bit-equal; the whole fold
    within ``RING_TOL`` of ``native``'s host fold (not for the special bits,
    whose huge random values overflow in an order-dependent way). Timed at
    the flagship geometry: per flush, per result, plain versions and library
    yardsticks, with the bound. With every rank on one card the stepwise
    design (``ring_fold_stepwise`` / ``ring_allgather_stepwise``, which the
    wrappers run across cards) is held to the same plain versions in every
    case, bit for bit, its launches exact. ``ranks(nd)`` -> (devices,
    cross_card) places the ranks."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.ops import mesh_collective as mcol

    mem_rate, _, f32_rate = peak
    gen = torch.Generator(device="cuda").manual_seed(2024)
    rng = np.random.default_rng(2024)
    flag_tiles = FLAT_N // CHUNK_N + 1  # 238, the last one short
    results = {}
    for nd in RING_NDS:
        devices, cross = ranks(nd)
        emit({"phase": "ring_ranks", "nd": nd, "devices": [str(d) for d in devices], "cross_card": cross,
              "device_count": torch.cuda.device_count()})
        codec = mc.MeshCodec(backend="device", mesh=_mesh(devices), collective="ring")
        ft = rng.choice(flag_tiles - 1, 12).tolist() + [flag_tiles - 1]
        ft = ft + ft[:3]  # repeated tiles within and across ranks; 16 chunks
        fw = rng.uniform(0.25, 2.0, len(ft)).astype(np.float32).tolist()
        fw[5] = 0.0
        rt = [0, 2, 1, 2, 0, 2, 1]
        cases = [
            ring_case("flagship", devices, FLAT_N, CHUNK_N, ft, fw, gen),
            ring_case("ragged", devices, 2 * 4100 + 77, 4100, rt, rng.uniform(0.5, 2.0, 7).tolist(), gen),
            ring_case("special", devices, 3 * 65536, 65536, [0, 1, 2, 1, 0, 2], [1.0, 0.0, 2.5, 0.5, 1.5, 3.0], gen,
                      special=True),
            # 600 chunks over 300 tiles: more metadata than one launch holds.
            ring_case("split", devices, 300 * 1024 - 5, 1024, rng.permutation(np.repeat(np.arange(300), 2)).tolist(),
                      rng.uniform(0.5, 2.0, 600).tolist(), gen),
        ]
        for case in cases:
            if case["tile"] % nd:
                continue
            accs_k, accs_p = ring_accs(case), ring_accs(case)
            init = [a.clone() for a in accs_k]
            rings = k6_rings(case["rank_tiles"], nd)
            before = dict(mcol.LAUNCHES)
            mcol.ring_fold(accs_k, case["bits"], case["rank_tiles"], case["rank_weights"], mcol.RingPartials(),
                           streams=codec.streams)
            fold_launches = mcol.LAUNCHES["ring_fold"] - before["ring_fold"]
            mcol.ring_fold_plain(accs_p, case["bits"], case["rank_tiles"], case["rank_weights"])
            outs_k = mcol.ring_allgather(accs_k, streams=codec.streams)
            gather_launches = mcol.LAUNCHES["ring_allgather"] - before["ring_allgather"]
            outs_p = mcol.ring_allgather_plain(accs_k)
            torch.cuda.synchronize()
            fold = [bits_equal(a, b) for a, b in zip(accs_k, accs_p)]
            gather = [bits_equal(a, b) for a, b in zip(outs_k, outs_p)]
            row = {
                "phase": "ring_kernels", "case": case["name"], "nd": nd, "cross_card": cross,
                "n_elems": case["n_elems"], "tile": case["tile"], "n_tiles": case["n_tiles"],
                "chunks": len(case["tiles"]), "distinct_tiles": len(set(case["tiles"])),
                "chunks_per_rank": [len(t) for t in case["rank_tiles"]],
                "ring_fold_vs_plain": fold, "ring_allgather_vs_plain": gather, "fold_rings": rings,
                "fold_launches": fold_launches, "gather_launches": gather_launches,
            }
            row["fold_launches_expected"], row["gather_launches_expected"] = ring_launches(devices, rings)
            ok = all(f["finite_lanes_differing"] == 0 and f["nonfinite_match"] for f in fold + gather)
            ok = ok and fold_launches == row["fold_launches_expected"]
            ok = ok and gather_launches == row["gather_launches_expected"]
            if not cross:  # the stepwise design's kernels, on the one card
                accs_s = ring_accs(case)
                before = dict(mcol.LAUNCHES)
                mcol.ring_fold_stepwise(accs_s, case["bits"], case["rank_tiles"], case["rank_weights"],
                                        mcol.RingPartials(), streams=codec.streams)
                step_fold = mcol.LAUNCHES["ring_fold"] - before["ring_fold"]
                outs_s = mcol.ring_allgather_stepwise(accs_k, streams=codec.streams)
                step_gather = mcol.LAUNCHES["ring_allgather"] - before["ring_allgather"]
                torch.cuda.synchronize()
                fold_s = [bits_equal(a, b) for a, b in zip(accs_s, accs_p)]
                gather_s = [bits_equal(a, b) for a, b in zip(outs_s, outs_p)]
                want_fold, want_gather = ring_launches(devices, rings, stepwise=True)
                row["stepwise"] = {
                    "ring_fold_vs_plain": fold_s, "ring_allgather_vs_plain": gather_s,
                    "fold_launches": step_fold, "fold_launches_expected": want_fold,
                    "gather_launches": step_gather, "gather_launches_expected": want_gather,
                }
                ok = ok and all(f["finite_lanes_differing"] == 0 and f["nonfinite_match"] for f in fold_s + gather_s)
                ok = ok and step_fold == want_fold and step_gather == want_gather
                del accs_s, outs_s
            if not case["special"]:
                got = outs_k[0].view(-1)[: case["n_elems"]].cpu().numpy()
                want = host_fold(case, init)
                err = np.abs(got.astype(np.float64) - want)
                lim = RING_TOL["atol"] + RING_TOL["rtol"] * np.abs(want)
                row["vs_host_fold"] = {"max_abs_err": float(err.max()), "limit_used": float((err / lim).max()),
                                       "finite": bool(np.isfinite(got).all()), **RING_TOL}
                ok = ok and row["vs_host_fold"]["limit_used"] <= 1.0 and row["vs_host_fold"]["finite"]
            row["ok"] = bool(ok)
            if not ok:
                emit(row)
                raise AssertionError(f"ring kernels disagree ({case['name']}, nd={nd})")
            if case["name"] == "flagship":
                row["timing"] = time_ring(case, codec, mem_rate, f32_rate)
            emit(row)
            results[(case["name"], nd)] = row
            del accs_k, accs_p, init, outs_k, outs_p
        del cases
        torch.cuda.empty_cache()
    return results


def kernel_device_ms(fn, kernel: str, iters: int = 10, per_call: int = 1) -> dict:
    """Device time per call of ``fn`` spent in kernels whose name holds
    ``kernel``, from a ``torch.profiler`` trace (the wrapper's host work and
    the gaps between its launches left out), for ``fn`` launching
    ``per_call`` such kernels: ``ms`` the mean of the kernel records the
    trace holds times ``per_call``, ``ms_per_iter`` their sum over
    ``iters``, ``records`` against ``expected`` (iters · per_call). The two
    differ only when the trace holds fewer or more records than the calls
    launched."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, records = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += next((float(getattr(evt, a)) for a in ("self_device_time_total", "self_cuda_time_total")
                              if getattr(evt, a, None)), 0.0)
            records += evt.count
    return {"ms": total_us / max(records, 1) * per_call / 1e3, "ms_per_iter": total_us / iters / 1e3,
            "records": records, "expected": iters * per_call}


def ring_tma_library():
    """The K7 design not kept (``experiments/torch_ring_variants.cu``: TMA
    bulk copies through shared-memory stages), built alone with nvcc
    (``ops/_build.py``'s flags) into ``build/ring_variants/`` when the
    library is missing or older than its source, and bound with ctypes. The
    port never loads it."""
    import ctypes

    from distributedvolunteercomputing_tpu_torch.ops import _build

    src = HERE / "experiments" / "torch_ring_variants.cu"
    out = HERE / "build" / "ring_variants" / "libtma.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
        tmp = out.with_suffix(f".{os.getpid()}.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.dvc_ring_allgather_tma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    lib.dvc_ring_allgather_tma.restype = ctypes.c_int
    lib.dvc_variant_error_string.argtypes = [ctypes.c_int]
    lib.dvc_variant_error_string.restype = ctypes.c_char_p
    return lib


def time_ring(case, codec, mem_rate, f32_rate) -> dict:
    """K6 per flagship flush, cycling ``FLUSH_SETS`` flushes over disjoint
    tiles and bits (their bytes exceed the L2, as K5's timing does), split
    over the ranks as the ring folder splits a batch, and K7 per result:
    through the wrapper (CUDA events around it, host packing included) and
    by device time, two ways side by side: calls enqueued behind a spin
    kernel (``device_ms``, as K1-K4; the number reported) and the profiler's
    kernel time (``kernel_device_ms``), which has read K7 under its bound.
    K6 also by device time of one flush repeated (its bytes stay in the L2:
    how earlier designs were timed). With every rank on one card, the K7
    design not kept (TMA) the same two ways. Plain versions, library
    yardsticks and bounds."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.ops import mesh_collective as mcol

    nd, tile, n_tiles, shard = case["nd"], case["tile"], case["n_tiles"], case["shard"]
    devices = case["devices"]
    accs = ring_accs(case)
    flag = codec_flushes("flagship", torch.Generator(device="cuda").manual_seed(99), np.random.default_rng(99))
    full = flag.pop("acc")
    per = -(-len(flag["sets"][0]["tiles"]) // nd)
    sets = []
    for f in flag["sets"]:
        own = [slice(min(d * per, len(f["tiles"])), min((d + 1) * per, len(f["tiles"]))) for d in range(nd)]
        sets.append((f, [f["bits"][sl].to(dev).contiguous() for sl, dev in zip(own, devices)],
                     [f["tiles"][sl] for sl in own], [f["weights"][sl] for sl in own]))
    partials = mcol.RingPartials()  # kept across flushes, as the ring folder keeps them (across cards)
    turn = itertools.count()

    def fold():
        _, bits, tiles, weights = sets[next(turn) % len(sets)]
        mcol.ring_fold(accs, bits, tiles, weights, partials, streams=codec.streams)

    args = (case["bits"], case["rank_tiles"], case["rank_weights"])

    def fold_same():
        mcol.ring_fold(accs, *args, partials, streams=codec.streams)

    def library():
        f = sets[next(turn) % len(sets)][0]
        full.index_add_(0, f["tiles_t"], f["dec"])

    f0 = flag["sets"][0]
    k, u = len(f0["tiles"]), len(set(f0["tiles"]))
    blocks = [[o[:, b * shard : (b + 1) * shard] for b in range(nd)] for o in
              [torch.empty((n_tiles, tile), device=dev) for dev in devices]]
    fold_bytes = k * tile * 2 + 2 * u * tile * 4 + 8 * k
    fold_flops = 2 * k * tile + u * tile
    gather_bytes = (1 + nd) * n_tiles * tile * 4
    per_flush, per_result = ring_launches(devices, 1)
    cycled = 8 * len(sets)
    out = {
        "K6": {
            "ms": time_ms(fold, iters=cycled),
            "device_ms": device_ms(fold, reps=cycled)["ms"],
            "device_ms_method": f"{cycled} calls enqueued behind a spin kernel (device_ms), {len(sets)} flushes"
                                " cycled",
            "device_ms_profiler": kernel_device_ms(fold, "ring_fold_kernel", iters=cycled),
            "device_ms_same_flush": device_ms(fold_same, reps=cycled)["ms"],
            "plain_ms": time_ms(lambda: mcol.ring_fold_plain(accs, *args), iters=5),
            "library_ms": time_ms(library, iters=cycled),
            "library_call": "acc.index_add_(0, tiles, w * widen(bits)) at full width, decode not timed",
            "flushes_cycled": len(sets), "bytes": fold_bytes, "flops": fold_flops,
            "launches_per_flush": per_flush,
            "bound_ms": max(fold_bytes / mem_rate, fold_flops / f32_rate) * 1e3,
            "bound_by": "bytes" if fold_bytes / mem_rate >= fold_flops / f32_rate else "operations",
        },
        "K7": {
            "ms": time_ms(lambda: mcol.ring_allgather(accs, streams=codec.streams)),
            "device_ms": device_ms(lambda: mcol.ring_allgather(accs, streams=codec.streams), reps=10)["ms"],
            "device_ms_method": "10 calls enqueued behind a spin kernel (device_ms)",
            "device_ms_profiler": kernel_device_ms(lambda: mcol.ring_allgather(accs, streams=codec.streams),
                                                   "ring_allgather_kernel"),
            "plain_ms": time_ms(lambda: mcol.ring_allgather_plain(accs), iters=5),
            "library_ms": time_ms(lambda: [blk.copy_(accs[b]) for row in blocks for b, blk in enumerate(row)]),
            "library_call": f"Tensor.copy_ of the same {nd * nd} blocks between the rank buffers",
            "bytes": gather_bytes, "flops": 0, "launches_per_result": per_result,
            "bound_ms": gather_bytes / mem_rate * 1e3, "bound_by": "bytes",
        },
    }
    if per_result == 1:  # every rank on one card: the design not kept, on the same inputs
        tma = ring_tma_library()
        outs = [torch.empty((n_tiles, tile), device=devices[0]) for _ in range(nd)]
        ptrs = mcol.card_gather_pack([a.data_ptr() for a in accs], [o.data_ptr() for o in outs])

        def gather_tma():
            err = tma.dvc_ring_allgather_tma(ptrs.buffer_info()[0], nd, n_tiles, shard,
                                             torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"tma_allgather: CUDA error {err}: {tma.dvc_variant_error_string(err).decode()}")

        gather_tma()
        want = mcol.ring_allgather_plain(accs)
        torch.cuda.synchronize()
        eq = [bits_equal(a, b) for a, b in zip(outs, want)]
        del want
        if any(e["finite_lanes_differing"] or not e["nonfinite_match"] for e in eq):
            raise AssertionError(f"the TMA all-gather differs from ring_allgather_plain: {eq}")
        out["K7"]["not_kept"] = {
            "design": "TMA 1-D bulk copies: one load into a ring of 4 shared-memory stages, nd bulk stores from it"
                      " (experiments/torch_ring_variants.cu)",
            "ms": time_ms(gather_tma), "device_ms": device_ms(gather_tma, reps=10)["ms"],
            "device_ms_profiler": kernel_device_ms(gather_tma, "tma_allgather_kernel"),
            "max_abs_err": max(e["max_abs_err"] for e in eq),
        }
        del outs
    del accs, sets, flag, full, blocks
    return out


def _mesh(devices):
    from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp=len(devices), devices=devices)


def dp_parity_phase(steps_timed: int = 5) -> dict:
    """One full-width gpt2_small step of the dp=2 trainer against the
    one-rank trainer, from the same init and batch, in f32: the averaged
    gradient's every leaf and the loss, then every param leaf after one
    clipped AdamW step, by its update (all in ``PARITY_TOL["dp"]``; the key
    bias, whose gradient is rounding noise that Adam normalizes to ~lr, is
    reported only). Then the dp=2 trainer's samples/s in its working dtype
    (bf16)."""
    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.parallel.train_step import dp_grad_half
    from distributedvolunteercomputing_tpu_torch.training.steps import grad_half
    from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
    from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import compute_dtype_as

    devices, cross = ring_ranks(2)
    bundle = get_model("gpt2_small")
    cfg = bundle.config
    batch = bundle.make_batch(torch.Generator().manual_seed(7), 8)
    with compute_dtype_as(torch.float32):
        one = Trainer(bundle, batch_size=8, lr=DP_LR)
        dp = Trainer(bundle, batch_size=8, lr=DP_LR, mesh=_mesh(devices))
        names = leaf_names(one.state.params)
        init = [p.clone() for p in tree_leaves(one.state.params)]
        g1, m1 = grad_half(bundle.loss_fn, one.state, one._to_device(batch))
        g2, m2 = dp_grad_half(bundle.loss_fn, dp.state, dp._to_device(batch))
        grads = leaf_diff(g2, g1, names)
        del g1, g2
        _, s1 = one._step_fn(one.state, one._to_device(batch))
        _, s2 = dp._step_fn(dp.state, dp._to_device(batch))
        torch.cuda.synchronize()
    tol = PARITY_TOL["dp"]
    kb = slice(cfg.d_model, 2 * cfg.d_model)
    params = {}
    key_bias = float("nan")
    replicas_equal = True
    for name, a, b, p0 in zip(names, tree_leaves(dp.state.params), tree_leaves(one.state.params), init):
        u_dp, u_one = a.full().float() - p0, b.float() - p0
        if name == "blocks/qkv/b":
            key_bias = (u_dp[:, kb] - u_one[:, kb]).abs().max().item()
            u_dp[:, kb] = u_one[:, kb] = 0.0
        params[name] = {
            "update_l2": ((u_dp - u_one).norm() / u_one.norm().clamp_min(1e-30)).item(),
            "max_abs_diff": (u_dp - u_one).abs().max().item(),
        }
    del init
    for leaf in dp.state.leaves():
        for s in leaf.shards[1:]:
            replicas_equal = replicas_equal and bool(torch.equal(s.to(leaf.shards[0].device), leaf.shards[0]))
    row = {
        "phase": "dp_parity", "model": bundle.name, "dp": 2, "devices": [str(d) for d in devices],
        "cross_card": cross, "batch_size": 8, "dtype": "float32",
        "loss_one": float(m1["loss"]), "loss_dp": float(m2["loss"]),
        "loss_rel_diff": abs(float(m1["loss"]) - float(m2["loss"])) / abs(float(m1["loss"])),
        "grad_norm_one": float(s1["grad_norm"]), "grad_norm_dp": float(s2["grad_norm"]),
        "grad_leaf": grads, "param_leaf": params, "key_bias_max_abs_diff": key_bias, "lr": DP_LR,
        "replicas_identical": replicas_equal, "tol": tol,
    }
    failures = [f"grad {n} {kind}" for n, e in grads.items() for kind in ("l2", "max")
                if not e[kind] <= tol[f"leaf_{kind}"]]
    failures += [f"param {n}" for n, e in params.items() if not e["update_l2"] <= tol["update_l2"]]
    if not row["loss_rel_diff"] <= tol["loss"]:
        failures.append("loss")
    if not abs(row["grad_norm_dp"] - row["grad_norm_one"]) <= tol["loss"] * 10 * row["grad_norm_one"]:
        failures.append("grad_norm")
    if not replicas_equal:
        failures.append("replicas differ after the step")
    del one, dp
    torch.cuda.empty_cache()
    # The dp=2 trainer on its main path (bf16): samples/s.
    trainer = Trainer(bundle, batch_size=8, mesh=_mesh(devices), total_steps=2 + steps_timed)
    trainer.run(steps=2, log_every=0)
    torch.cuda.synchronize()
    summary = trainer.run(steps=steps_timed, log_every=0)
    row.update(dp_samples_per_sec=summary["samples_per_sec"], dp_step_ms=summary["wall_time_s"] / steps_timed * 1e3,
               dp_timed_steps=steps_timed, dp_final_loss=summary["final_loss"])
    if not math.isfinite(summary["final_loss"]):
        failures.append("non-finite dp loss")
    emit(row)
    del trainer
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"dp=2 step disagrees with the one-rank step: {failures}")
    return row


# ---------------------------------------------------------------------------
# the volunteer's model-parallel mesh and gpt2_moe (phases 31-33)
# ---------------------------------------------------------------------------

MESH_DEVICE = "cuda:0"  # every rank of phases 31-33 shares the one card
MESH_BATCH = 8
# layout -> (mesh axes, zero1, fsdp, grads mode: grad step then apply step)
MESH_LAYOUTS = {
    "dp2tp2": (dict(dp=2, tp=2), False, False, False),
    "dp2_zero1": (dict(dp=2), True, False, False),
    "dp2tp2_fsdp": (dict(dp=2, tp=2), False, True, False),
    "dp2tp2_grads": (dict(dp=2, tp=2), False, False, True),
}
# name -> (router_top_k, mesh axes): the reference's test meshes
MOE_MESHES = {
    "top1_ep2tp2": (1, dict(ep=2, tp=2)),
    "top2_dp2ep2tp2": (2, dict(dp=2, ep=2, tp=2)),
}
# gpt2_moe on a mesh against one rank, f32: loss, lm_loss and aux_loss
# relative; each leaf's first update by relative l2 (Adam's first update
# normalizes each gradient element, PARITY_TOL's reason); the share of
# routing decisions that differ. Routing is discrete: rounding in the tp
# partial sums can flip a near-tie among 8192 tokens, and a flip moves the
# loss by about one token's share.
MOE_TOL = {"loss": 1e-4, "update_l2": 1e-3, "routing": 1e-3}
MESH_SWARM_COMMITS = 2  # committed rounds each mesh volunteer must make
MESH_SWARM_WAIT_S = 240.0  # cap on the wait for them
MESH_SWARM_STRIDE = 97  # the value checks read every 97th element of the flat payload


def mesh_of(axes: dict):
    from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(**axes, devices=[MESH_DEVICE] * math.prod(axes.values()))


def spec_bytes(state) -> dict:
    """Per rank: the param and moment bytes the placements imply (each
    leaf's local shape times its element size)."""
    def size(sh, dtype):
        return math.prod(sh.local_shape()) * torch.tensor([], dtype=dtype).element_size()

    leaves = state.leaves()
    n = len(state.layout.devices)
    params = sum(size(leaf.sharding, leaf.dtype) for leaf in leaves)
    moments = sum(size(state.opt_shardings[i], leaf.dtype) for name in state.moment_names()
                  for i, leaf in enumerate(leaves) if state.opt_state[name][i] is not None)
    return {"params": [params] * n, "moments": [moments] * n}


def update_diff(names, got, want, init, d_model: int) -> tuple:
    """Per leaf: ||u_got - u_want|| / ||u_want|| of the updates from
    ``init``, and the key bias's max abs difference (reported only: its
    exact gradient is 0)."""
    out, key_bias = {}, float("nan")
    kb = slice(d_model, 2 * d_model)
    for name, a, b, p0 in zip(names, got, want, init):
        u_a, u_b = a.float() - p0.float(), b.float() - p0.float()
        if name == "blocks/qkv/b":
            key_bias = (u_a[:, kb] - u_b[:, kb]).abs().max().item()
            u_a[:, kb] = u_b[:, kb] = 0.0
        out[name] = ((u_a - u_b).norm() / u_b.norm().clamp_min(1e-30)).item()
    return out, key_bias


def mesh_step_phase(layouts=None, model: str = "gpt2_small", overrides=None) -> dict:
    """Phase 31 (see the module doc): each layout of ``MESH_LAYOUTS`` against
    one rank, f32, 2 AdamW steps from one init and one batch."""
    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa
    from distributedvolunteercomputing_tpu_torch.parallel import train_step as pts
    from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
    from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, grad_half, make_train_step
    from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_flatten, tree_leaves, tree_map
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import compute_dtype_as

    layouts = MESH_LAYOUTS if layouts is None else layouts
    bundle = get_model(model, **(overrides or {}))
    cfg = bundle.config
    dev = torch.device(MESH_DEVICE)
    batch = bundle.make_batch(torch.Generator().manual_seed(7), MESH_BATCH)
    per_step = dict(zip(KERNELS, flash_per_step(model, overrides)))
    tol = PARITY_TOL["dp"]
    failures, rows, launches = [], {}, collections.Counter()
    release_card_memory()
    with compute_dtype_as(torch.float32):
        params0 = bundle.init(torch.Generator(device=dev).manual_seed(0))
        names = leaf_names(params0)
        init = tree_leaves(params0)
        tx1 = make_optimizer("adamw", lr=DP_LR)
        one = TrainState.create(tree_map(torch.clone, params0), tx1, torch.Generator(device=dev))
        b1 = {k: v.to(dev) for k, v in batch.items()}
        g_ref, m_ref = grad_half(bundle.loss_fn, one, b1)
        step1 = make_train_step(bundle.loss_fn, tx1)
        cuda_sync()
        t0 = time.perf_counter()
        one, s_ref = step1(one, b1)
        cuda_sync()
        one_s = time.perf_counter() - t0
        after_ref = [p.clone() for p in tree_leaves(one.params)]
        del one
        for name, (axes, zero1, fsdp, grads_mode) in layouts.items():
            mesh = mesh_of(axes)
            tx = make_optimizer("adamw", lr=DP_LR)
            state, _ = pts.shard_train_state(TrainState.create(tree_map(torch.clone, params0), tx,
                                                               torch.Generator(device=dev)), mesh, zero1=zero1, fsdp=fsdp)
            shares = pts.put_batch(batch, mesh)
            if grads_mode:
                grad_fn = pts.make_sharded_grad_step(bundle.loss_fn, mesh)
                apply_fn = pts.make_sharded_apply_step(tx, mesh)

                def step(st):
                    g, m, rng = grad_fn(st, shares)
                    return apply_fn(st, g, rng), m, tree_flatten(g)[0]
            else:
                fused = pts.make_sharded_train_step(bundle.loss_fn, tx, mesh, zero1=zero1, fsdp=fsdp)

                def step(st):
                    g, _ = pts.dp_grad_half(bundle.loss_fn, st, shares)
                    st, m = fused(st, shares)
                    return st, m, g

            state, m1, grads = step(state)
            grad_rows = leaf_diff(grads, g_ref, names)
            del grads
            updates, key_bias = update_diff(names, [leaf.full() for leaf in state.leaves()], after_ref, init,
                                            cfg.d_model)
            got_bytes, want_bytes = state.bytes_per_rank(), spec_bytes(state)
            # Step 2: the launches and the time of one step of the layout.
            cuda_sync()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            if grads_mode:
                g, m2, rng = grad_fn(state, shares)
                apply_fn(state, g, rng)
                del g
            else:
                state, m2 = fused(state, shares)
            cuda_sync()
            step_s = time.perf_counter() - t0
            got_launches = dict(fa.LAUNCHES)
            launches.update(got_launches)
            attend = axes.get("dp", 1) * axes.get("tp", 1)
            want_launches = {k: attend * v for k, v in per_step.items()}
            loss_rel = abs(float(m1["loss"]) - float(m_ref["loss"])) / abs(float(m_ref["loss"]))
            row = {
                "phase": "mesh_step", "layout": name, "mesh": axes, "zero1": zero1, "fsdp": fsdp,
                "grads_mode": grads_mode, "model": bundle.name, "n_layers": cfg.n_layers, "batch_size": MESH_BATCH,
                "dtype": "float32", "ranks": [str(d) for d in mesh.flat()], "loss_one": float(m_ref["loss"]),
                "loss_mesh": float(m1["loss"]), "loss_rel_diff": loss_rel, "grad_norm_one": float(s_ref["grad_norm"]),
                "grad_norm_mesh": float(m1["grad_norm"]), "grad_leaf": grad_rows, "update_l2": updates,
                "key_bias_max_abs_diff": key_bias, "bytes_per_rank": got_bytes, "bytes_per_rank_specs": want_bytes,
                "bytes_note": "tensors each rank holds; the ranks share one card, whose memory does not shrink",
                "launches": got_launches, "launches_expected": want_launches, "step_s": step_s,
                "samples_per_sec": MESH_BATCH / step_s, "one_rank_samples_per_sec": MESH_BATCH / one_s,
                "loss_step2": float(m2["loss"]), "tol": tol,
            }
            emit(row)
            rows[name] = row
            bad = [f"grad {n} {k}" for n, e in grad_rows.items() for k in ("l2", "max") if not e[k] <= tol[f"leaf_{k}"]]
            bad += [f"update {n}" for n, u in updates.items() if not u <= tol["update_l2"]]
            if not loss_rel <= tol["loss"]:
                bad.append("loss")
            if got_bytes != want_bytes:
                bad.append(f"bytes per rank {got_bytes} != the specs' {want_bytes}")
            if {k: got_launches.get(k, 0) for k in want_launches} != want_launches:
                bad.append(f"K1-K3 launches {got_launches} != {want_launches}")
            if not math.isfinite(float(m2["loss"])):
                bad.append("non-finite second loss")
            failures += [f"{name}: {b}" for b in bad]
            del state, shares, m1, m2
            release_card_memory()
    del params0, after_ref, g_ref, init
    release_card_memory()
    if failures:
        raise AssertionError(f"mesh_step: {failures}")
    return dict(launches)


def routing_rows(log, groups: int) -> list:
    """Per layer: (top_idx, kept) of the whole batch from a routing log that
    holds ``groups`` entries per layer (one per dp group, in batch order)."""
    out = []
    for i in range(0, len(log), groups):
        part = log[i:i + groups]
        out.append((torch.cat([r["top_idx"] for r in part]), torch.cat([r["kept"] for r in part])))
    return out


def moe_phase(meshes=None, overrides=None) -> dict:
    """Phase 32 (see the module doc): gpt2_moe on ``MOE_MESHES`` against
    one rank, f32, one AdamW step from one init and one batch."""
    from distributedvolunteercomputing_tpu_torch.models import get_model, moe
    from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa
    from distributedvolunteercomputing_tpu_torch.parallel import train_step as pts
    from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
    from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, make_train_step
    from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves, tree_map
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import compute_dtype_as

    meshes = MOE_MESHES if meshes is None else meshes
    dev = torch.device(MESH_DEVICE)
    failures, rows, launches = [], {}, collections.Counter()
    for name, (top_k, axes) in meshes.items():
        release_card_memory()
        over = dict(overrides or {}, router_top_k=top_k)
        bundle = get_model("gpt2_moe", **over)
        cfg = bundle.config
        per_step = dict(zip(KERNELS, flash_per_step("gpt2_moe", over)))
        batch = bundle.make_batch(torch.Generator().manual_seed(9), MESH_BATCH)
        with compute_dtype_as(torch.float32):
            params0 = bundle.init(torch.Generator(device=dev).manual_seed(0))
            names = leaf_names(params0)
            b1 = {k: v.to(dev) for k, v in batch.items()}
            with moe.routing_log() as log_one, torch.no_grad():
                bundle.loss_fn(params0, b1, torch.Generator(device=dev))
            tx1 = make_optimizer("adamw", lr=DP_LR)
            one = TrainState.create(tree_map(torch.clone, params0), tx1, torch.Generator(device=dev))
            cuda_sync()
            t0 = time.perf_counter()
            one, m_one = make_train_step(bundle.loss_fn, tx1)(one, b1)
            cuda_sync()
            one_s = time.perf_counter() - t0
            after_one = [p.clone() for p in tree_leaves(one.params)]
            del one
            mesh = mesh_of(axes)
            tx = make_optimizer("adamw", lr=DP_LR)
            state, _ = pts.shard_train_state(TrainState.create(tree_map(torch.clone, params0), tx,
                                                               torch.Generator(device=dev)), mesh)
            shares = pts.put_batch(batch, mesh)
            with moe.routing_log() as log_mesh:
                pts.make_sharded_eval_step(bundle.loss_fn, mesh)(state, batch)
            step = pts.make_sharded_train_step(bundle.loss_fn, tx, mesh)
            cuda_sync()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            state, m = step(state, shares)
            cuda_sync()
            step_s = time.perf_counter() - t0
            got_launches = dict(fa.LAUNCHES)
            launches.update(got_launches)
        groups = axes.get("dp", 1)
        ref_rows, mesh_rows = routing_rows(log_one, 1), routing_rows(log_mesh, groups)
        decisions = differ = 0
        dropped = []
        for (ti, ki), (tm, km) in zip(ref_rows, mesh_rows):
            decisions += ti.numel()
            differ += int(((ti != tm) | (ki != km)).sum())
            dropped.append([1.0 - float(ki[:, c].float().mean()) for c in range(top_k)])
        updates, key_bias = update_diff(names, [leaf.full() for leaf in state.leaves()], after_one,
                                        tree_leaves(params0), cfg.d_model)
        ep_tp = axes.get("ep", 1) * axes.get("tp", 1)
        expert_bytes = {}
        for n, leaf in zip(names, state.leaves()):
            if n.endswith(("moe_in", "moe_out")):
                expert_bytes[n] = {"per_rank": leaf.nbytes_per_rank(),
                                   "whole": math.prod(leaf.shape) * torch.tensor([], dtype=leaf.dtype).element_size()}
        losses = {k: (float(m_one[k]), float(m[k]), abs(float(m[k]) - float(m_one[k])) / abs(float(m_one[k])))
                  for k in ("loss", "lm_loss", "aux_loss")}
        want_launches = {k: axes.get("dp", 1) * axes.get("tp", 1) * v for k, v in per_step.items()}
        row = {
            "phase": "moe", "mesh_name": name, "mesh": axes, "router_top_k": top_k, "n_layers": cfg.n_layers,
            "n_experts": cfg.n_experts, "d_ff": cfg.d_ff, "capacity_factor": cfg.capacity_factor,
            "batch_size": MESH_BATCH, "dtype": "float32", "losses_one_mesh_rel": losses, "update_l2": updates,
            "key_bias_max_abs_diff": key_bias, "routing_decisions": decisions, "routing_differ": differ,
            "routing_differ_share": differ / max(decisions, 1), "dropped_share_per_layer": dropped,
            "expert_bytes": expert_bytes, "launches": got_launches, "launches_expected": want_launches,
            "step_s": step_s, "samples_per_sec": MESH_BATCH / step_s, "one_rank_samples_per_sec": MESH_BATCH / one_s,
            "tol": MOE_TOL,
        }
        emit(row)
        rows[name] = row
        bad = [f"{k} {v}" for k, v in losses.items() if not v[2] <= MOE_TOL["loss"]]
        bad += [f"update {n} {u}" for n, u in updates.items() if not u <= MOE_TOL["update_l2"]]
        if not row["routing_differ_share"] <= MOE_TOL["routing"] or len(mesh_rows) != cfg.n_layers:
            bad.append(f"routing differs on {differ} of {decisions} decisions")
        for n, e in expert_bytes.items():
            if e["per_rank"] != [e["whole"] // ep_tp] * len(e["per_rank"]):
                bad.append(f"{n} per rank {e['per_rank']} != 1/{ep_tp} of {e['whole']}")
        if {k: got_launches.get(k, 0) for k in want_launches} != want_launches:
            bad.append(f"K1-K3 launches {got_launches} != {want_launches}")
        failures += [f"{name}: {b}" for b in bad]
        del state, shares, params0, after_one, log_one, log_mesh, ref_rows, mesh_rows
    release_card_memory()
    if failures:
        raise AssertionError(f"moe: {failures}")
    return dict(launches)


def mesh_swarm_child(record_dir: str, argv: list) -> int:
    """A mesh volunteer of phase 33: ``run_volunteer_torch.py``'s ``main``
    with ``argv``, under a recorder. Per round it keeps the group it formed
    (epoch, leader, size), the contribution's weight and the schema hash
    and, when it committed, every ``MESH_SWARM_STRIDE``-th element of the
    flat contribution and of the result; after each merge, whether
    every rank's slices equal the merged payload's (compared on the card).
    The ``--mesh`` spec's ranks, which would go on the visible cards, all
    go on ``MESH_DEVICE`` (``mesh_of``): the driver's machine has one card."""
    import runpy

    import numpy as np

    sys.path.insert(0, str(HERE))
    from distributedvolunteercomputing_tpu_torch.swarm import averager as amod
    from distributedvolunteercomputing_tpu_torch.swarm import volunteer as vmod
    from distributedvolunteercomputing_tpu_torch.training import trainer as tmod
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer, tree_flatten

    out = Path(record_dir)
    out.mkdir(parents=True, exist_ok=True)
    run_round, swap = tmod.Trainer._run_average_round, tmod.Trainer._swap_params
    form_group = amod.SyncAverager._form_group
    seen = {"rounds": 0, "group": None}

    async def recorded_form_group(self, round_key):
        group = await form_group(self, round_key)
        seen["group"] = None if group is None else {
            "epoch": group.epoch, "leader": group.members[0][0], "size": len(group.members), "me": self.peer_id}
        return group

    def log(entry):
        with open(out / "records.jsonl", "a") as f:
            f.write(json.dumps(entry) + "\n")

    def recorded_round(self, step_no):
        seen["group"] = None
        payload, merged = run_round(self, step_no)
        i = seen["rounds"]
        seen["rounds"] += 1
        entry = {"kind": "round", "step": step_no, "ok": merged is not None, "t": time.time(), "round": i,
                 "weight": self.batch_size * self.steps_since_merge, "group": seen["group"],
                 "schema": getattr(getattr(self, "_wire_averager", None), "_schema", None)}
        if merged is not None:
            np.save(out / f"payload{i}.npy", flatten_to_buffer(payload)[0][::MESH_SWARM_STRIDE])
            np.save(out / f"result{i}.npy", flatten_to_buffer(merged)[0][::MESH_SWARM_STRIDE])
        log(entry)
        return payload, merged

    def recorded_swap(self, payload, step_no):
        swap(self, payload, step_no)
        equal, leaves = True, 0
        with torch.no_grad():
            for leaf, v in zip(tree_flatten(self.bundle.avg_select(self.state.params))[0], tree_flatten(payload)[0]):
                full = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(leaf.device)
                for r, s in enumerate(leaf.shards):
                    equal &= bool(torch.equal(s, full[leaf.sharding.index(r)].to(s.device, s.dtype)))
                leaves += 1
        log({"kind": "merge", "step": step_no, "slices_equal": equal, "leaves": leaves,
             "ranks": len(self.mesh.flat()) if self.mesh is not None else 1})

    tmod.Trainer._run_average_round, tmod.Trainer._swap_params = recorded_round, recorded_swap
    amod.SyncAverager._form_group = recorded_form_group
    make_mesh = vmod.make_mesh  # a spec's ranks on the visible cards go on MESH_DEVICE
    vmod.make_mesh = lambda devices=None, **axes: make_mesh(devices=devices, **axes) if devices else mesh_of(axes)
    sys.argv = ["run_volunteer_torch.py", *argv]
    main_fn = runpy.run_path(str(HERE / "run_volunteer_torch.py"))["main"]
    main_fn()
    return 0


def mesh_swarm_phase(overrides=None, extra_argv=()) -> dict:
    """Phase 33 (see the module doc); ``overrides`` (``DEPTH_CUT`` by
    default) and ``extra_argv`` go to both volunteers."""
    import shutil
    import signal
    import tempfile

    import numpy as np

    from distributedvolunteercomputing_tpu_torch import native
    from distributedvolunteercomputing_tpu_torch.training.checkpoint import latest_step

    if not native.ensure_built():
        raise RuntimeError("the host codec's C++ core did not build")
    (HERE / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="mesh_swarm_", dir=HERE / "build"))
    over = DEPTH_CUT if overrides is None else overrides
    release_card_memory()
    vols = {"A": ["--mesh", "ep=2,tp=2"], "B": ["--mesh", "dp=2", "--fsdp"]}
    procs = {}

    async def spawn(name, argv):
        procs[name] = await asyncio.create_subprocess_exec(
            sys.executable, *map(str, argv), cwd=str(HERE),
            stdout=asyncio.subprocess.PIPE if name == "coord" else open(tmp / f"{name}.out", "w"),
            stderr=open(tmp / f"{name}.log", "w"))
        return procs[name]

    def records(name):
        return read_jsonl(tmp / name / "records.jsonl")

    def tail(name):
        p = tmp / f"{name}.log"
        return p.read_text()[-3000:] if p.exists() else ""

    async def main():
        try:
            return await swarm()
        finally:  # every process this phase started ends here, inside the loop
            for p in procs.values():
                if p.returncode is None:
                    p.kill()
                    await p.wait()

    async def swarm():
        t_coord = time.perf_counter()
        coord = await spawn("coord", [HERE / "coordinator_torch.py", "--port", "0"])
        line = await asyncio.wait_for(coord.stdout.readline(), 120)
        if not line.startswith(b"COORDINATOR_READY"):
            raise AssertionError(f"coordinator: {line!r} {tail('coord')}")
        addr = line.split()[1].decode()
        timing["coord_s"] = time.perf_counter() - t_coord
        timing["spawn_t"] = time.time()
        t0 = time.perf_counter()
        for i, (name, mesh_args) in enumerate(vols.items()):
            await spawn(name, [HERE / "chip_smoke.py", "--mesh-swarm-child", tmp / name, "--",
                               "--model", "gpt2_moe", "--batch-size", MESH_BATCH,
                               *[a for k, v in over.items() for a in ("--model-override", f"{k}={v}")],
                               "--averaging", "sync", "--wire", "bf16", "--average-every", AVG_EVERY, "--no-overlap",
                               "--coordinator", addr, "--checkpoint-dir", tmp / f"ckpt_{name}",
                               "--checkpoint-every", 100000, "--peer-id", f"mesh{name}", "--seed", i + 1,
                               "--steps", 100000, *mesh_args, *extra_argv])
        deadline = time.monotonic() + MESH_SWARM_WAIT_S
        while not all(sum(r.get("ok", False) for r in records(n) if r["kind"] == "round") >= MESH_SWARM_COMMITS
                      for n in vols):
            for n in vols:
                if procs[n].returncode is not None:
                    raise AssertionError(f"mesh volunteer {n} exited ({procs[n].returncode}): {tail(n)}")
            if time.monotonic() > deadline:
                raise AssertionError(f"mesh_swarm: not {MESH_SWARM_COMMITS} commits each within "
                                     f"{MESH_SWARM_WAIT_S} s: { {n: records(n) for n in vols} }")
            await asyncio.sleep(0.5)
        train_s = time.perf_counter() - t0
        rcs = {}
        t_stop = time.perf_counter()
        for n in vols:
            procs[n].send_signal(signal.SIGTERM)
        for n in vols:
            try:
                rcs[n] = await asyncio.wait_for(procs[n].wait(), 240)
            except asyncio.TimeoutError:
                procs[n].kill()
                await procs[n].wait()
                raise AssertionError(f"mesh volunteer {n} did not exit within 240 s of SIGTERM")
        timing["stop_s"] = time.perf_counter() - t_stop
        return train_s, rcs

    failures, timing = [], {}
    try:
        train_s, rcs = asyncio.run(main())
        # Seconds from the spawn to each volunteer's committed rounds: start-up
        # (the card, the model, the mesh, the swarm) is the first one's most.
        for n in vols:
            timing[f"{n}_round_s"] = [r["t"] - timing["spawn_t"] for r in records(n) if r["kind"] == "round"]
        out = {"phase": "mesh_swarm", "model": "gpt2_moe", "overrides": over, "train_s": train_s, "rc": rcs,
               "seconds": {k: v for k, v in timing.items() if k != "spawn_t"},
               "meshes": vols}
        recs = {n: records(n) for n in vols}
        for n in vols:
            done = [ln for ln in (tmp / f"{n}.out").read_text().splitlines() if ln.startswith("VOLUNTEER_DONE ")]
            steps = json.loads(done[-1].split(" ", 1)[1])["steps"] if done else None
            final = latest_step(str(tmp / f"ckpt_{n}"))
            merges = [r for r in recs[n] if r["kind"] == "merge"]
            rounds = [r for r in recs[n] if r["kind"] == "round"]
            out[n] = {"rounds": rounds, "merges": merges, "steps": steps, "final_step_N": final}
            if rcs[n] != 0 or final is None or final != steps:
                failures.append(f"{n} on SIGTERM: rc {rcs[n]}, final step_N {final}, its steps {steps}")
            if sum(r["ok"] for r in rounds) < MESH_SWARM_COMMITS:
                failures.append(f"{n}: {sum(r['ok'] for r in rounds)} committed rounds")
            if not merges or not all(m["slices_equal"] for m in merges):
                failures.append(f"{n}: a rank's slices differ from the merged payload's: {merges}")
        schemas = {r["schema"] for n in vols for r in recs[n] if r["kind"] == "round" and r["ok"]}
        out["schemas"] = sorted(s for s in schemas if s)
        if len(schemas) != 1 or None in schemas:
            failures.append(f"schema hashes {schemas}")
        # The same round on both sides: the one epoch its group carried. The
        # group's leader folded the contributions; a round one of them
        # committed alone has no partner.
        def committed(n):
            return {r["group"]["epoch"]: r for r in recs[n] if r["kind"] == "round" and r["ok"] and r["group"]}

        by_epoch = [committed(n) for n in vols]
        pairs = [[], []]
        for epoch in sorted(set(by_epoch[0]) & set(by_epoch[1]), key=lambda e: by_epoch[0][e]["round"]):
            for side, n in enumerate(vols):
                r = by_epoch[side][epoch]
                pairs[side].append({"round": len(pairs[side]), "step": r["step"], "weight": r["weight"],
                                    "led_streamed": r["group"]["leader"] == r["group"]["me"],
                                    "payload": np.load(tmp / n / f"payload{r['round']}.npy"),
                                    "result": np.load(tmp / n / f"result{r['round']}.npy")})
        out["epochs_paired"] = len(pairs[0])
        # The leader's result must be named from the record: the member's is
        # the leader's rounded to bf16 once more, and after a skipped round
        # its max abs error can be the smaller one
        # (experiments/torch_mesh_swarm_leader.py).
        for a, b in zip(*pairs):
            if a["led_streamed"] == b["led_streamed"]:
                failures.append(f"round at step {a['step']}: not exactly one leader recorded")
        out["values"] = check_averaged_values(pairs, failures, all_rounds=True)
        out["value_stride"] = MESH_SWARM_STRIDE
        emit(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError(f"mesh_swarm: {failures}")
    return out


def flash_launches() -> dict:
    from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa

    return dict(fa.LAUNCHES)


HOPPER_KERNELS = (  # mangled-name marks of the bf16 K1, K2 and K3
    "6hopper16flash_fwd_kernel", "6hopper15flash_dq_kernel", "6hopper16flash_dkv_kernel",
)


def kernel_build_report(log: str, library: str) -> dict:
    """Per kernel (mangled name): ptxas registers and spill bytes from the
    build log, HGMMA instructions in ``cuobjdump -sass`` of the library."""
    import re
    import shutil

    from distributedvolunteercomputing_tpu_torch.ops import _build

    kernels = collections.defaultdict(dict)
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            kernels[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            kernels[current]["registers"] = int(m.group(1))
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        cuobjdump = Path(shutil.which("cuobjdump") or "cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True, text=True, check=True).stdout
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            kernels[current].setdefault("hgmma", 0)
        elif current and "HGMMA" in line:
            kernels[current]["hgmma"] += 1
    return dict(kernels)


def build_phase() -> dict:
    from distributedvolunteercomputing_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log = _build.build_info.get("log", "")
    report = kernel_build_report(log, _build.build_info["path"])
    row = {
        "phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": _build.build_info.get("seconds"),
        "library": _build.build_info["path"], "command": _build.build_info.get("command"),
        "kernels": report,
        "ptxas_warnings": [ln.strip() for ln in log.splitlines() if "warning" in ln.lower()],
    }
    emit(row)
    if not log:
        raise AssertionError("no ptxas report beside the library: delete build/torch_kernels and rerun")
    hopper = {n: r for n, r in report.items() if any(mark in n for mark in HOPPER_KERNELS)}
    bad = {n: r for n, r in hopper.items() if not r.get("hgmma") or r.get("spill_bytes", 1) != 0}
    if len(hopper) != 2 * len(HOPPER_KERNELS) or bad:
        raise AssertionError(f"Hopper K1/K2/K3 must hold HGMMA and spill nothing (D 64 and 128): {hopper}")
    return row


def timed(name: str, fn, *args, **kwargs):
    """Run one phase and print its wall seconds on a line of its own (also
    when it fails), so a run shows where its time went."""
    t0 = time.perf_counter()
    ok = False
    try:
        out = fn(*args, **kwargs)
        ok = True
        return out
    finally:
        emit({"phase_wall": name, "seconds": time.perf_counter() - t0, "ok": ok})


def reset_all_launch_counts() -> None:
    from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.ops import mesh_collective as mcol

    fa.reset_launch_counts()
    mc.reset_launch_counts()
    mcol.reset_launch_counts()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device

    resolve_device(None)  # pins TF32 off for the f32 references
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": name, "count": torch.cuda.device_count(), "nvidia_smi": smi,
    })
    peak = peaks(name)

    timed("build", build_phase)

    def kernel_checks():
        flagship = check_kernels(fa, FLAGSHIP, torch.bfloat16, True, peak)
        check_kernels(fa, FLAGSHIP, torch.bfloat16, True, peak, layout="qkv")
        b, h, _, d = FLAGSHIP
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (False, True):
                check_kernels(fa, (2, h, RAGGED_T, d), dtype, causal, peak)
        for causal in (False, True):
            check_kernels(fa, D128, torch.bfloat16, causal, peak)
        return flagship

    flagship = timed("kernels", kernel_checks)
    times = timed("attention_timing", time_attention, fa, peak)
    model_attention = timed("model_kernels", model_kernels_phase, fa, peak)

    launches = timed("trainer", trainer_phase, fa)
    modes = timed("multi_step", multi_step_phase, fa)
    codec = timed("codec", codec_phase, peak)
    launches.update(timed("averaging", averaging_phase))
    modes["grad_averaging"] = timed("grad_averaging", grad_averaging_phase)
    modes["outer_sync"] = timed("outer_sync", outer_sync_phase)
    ring = timed("ring_kernels", ring_kernels_phase, peak)
    timed("dp_parity", dp_parity_phase)
    devices, _ = ring_ranks(2)
    ring_counts = timed("ring_averaging", averaging_phase, mesh=_mesh(devices), collective="ring",
                        phase="ring_averaging", overrides=DEPTH_CUT)
    launches.update({k: ring_counts[k] for k in RING_KERNELS})
    life_launches = timed("lifecycle", lifecycle_phase)
    protocols = {"gossip": timed("gossip", gossip_phase, model_overrides=dict(DEPTH_CUT)),
                 "butterfly": timed("butterfly", butterfly_phase),
                 "byzantine": timed("byzantine", byzantine_phase, overrides=DEPTH_CUT)}
    faults = {"zones": timed("zones", zones_phase), "failover": timed("failover", failover_phase),
              "hedge": timed("hedge", hedge_phase)}
    wires = timed("wires", wires_phase)
    wires["psgd_byzantine"] = timed("psgd_byzantine", compressed_byzantine_phase, "psgd_byzantine", "powersgd",
                                    PSGD_RANK)
    wires["sign_byzantine"] = timed("sign_byzantine", compressed_byzantine_phase, "sign_byzantine", "sign")
    wires["zone_shards"] = timed("zone_shards", zone_shards_phase)
    timed("mnist", mnist_phase)
    data_dir = HERE / "build" / "chip_smoke" / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    try:
        timed("mnist_file", mnist_file_phase, data_dir)
        models = {
            "vit": timed("vit", vit_phase),
            "resnet_sync": timed("resnet_sync", averaging_phase, phase="resnet_sync", **RESNET),
            "bert_gossip": timed("bert_gossip", gossip_phase, phase="bert_gossip", model_overrides=dict(DEPTH_CUT),
                                 **BERT),
            "llama_byzantine": timed("llama_byzantine", byzantine_phase, phase="llama_byzantine",
                                     overrides=llama2_7b(), **LLAMA),
        }
        modes["resnet_file"] = timed("resnet_file", resnet_file_phase, data_dir)
    finally:
        import shutil

        shutil.rmtree(data_dir, ignore_errors=True)
    mesh = {"mesh_step": timed("mesh_step", mesh_step_phase), "moe": timed("moe", moe_phase)}
    timed("mesh_swarm", mesh_swarm_phase)

    def protocol_launches(kname):
        return {phase: counts[kname] for phase, counts in protocols.items()}

    def model_launches(kname):
        return {phase: counts.get(kname, 0) for phase, counts in models.items()}

    def mode_launches(kname):
        return {phase: counts.get(kname, 0) for phase, counts in modes.items()}

    def fault_launches(kname):
        return {phase: counts.get(kname, 0) for phase, counts in faults.items()}

    def wire_launches(kname):
        return {phase: counts.get(kname, 0) for phase, counts in wires.items()}

    def mesh_launches(kname):
        return {phase: counts.get(kname, 0) for phase, counts in mesh.items()}

    def model_shapes(kname):
        """K1-K3 at each model's main-path shape: error, device ms, plain,
        bound and SDPA, as at the flagship shape."""
        out = {}
        for model, m in model_attention.items():
            r, t = m["checks"][kname], m["times"]
            lib = "sdpa_fwd" if kname == "flash_fwd" else "sdpa_fwd_bwd"
            out[model] = {"shape": m["shape"], "causal": m["causal"], "max_abs_err": r["max_abs_err"],
                          "ms": t[kname]["ms"], "plain_ms": t[kname]["plain_ms"], "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"], "library_ms": t[lib]["ms"]}
        return out

    kernels = []
    for kname, (replaces, kid) in KERNELS.items():
        r, t = flagship[kname], times["contiguous"]
        lib = "sdpa_fwd" if kname == "flash_fwd" else "sdpa_fwd_bwd"
        kernels.append({
            "name": kname, "id": kid, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[kname], "launches_lifecycle": life_launches[kname],
            "launches_protocols": protocol_launches(kname), "launches_models": model_launches(kname),
            "launches_trainer_modes": mode_launches(kname), "launches_faults": fault_launches(kname),
            "launches_wires": wire_launches(kname), "launches_mesh": mesh_launches(kname),
            "shapes_models": model_shapes(kname), "max_abs_err": r["max_abs_err"], "ms": t[kname]["ms"],
            "ms_method": DEVICE_MS_METHOD, "ms_qkv_view": times["qkv"][kname]["ms"],
            "plain_ms": t[kname]["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": t[lib]["ms"], "library_ms_qkv_view": times["qkv"][lib]["ms"],
            "library_call": "F.scaled_dot_product_attention forward" if lib == "sdpa_fwd"
            else "F.scaled_dot_product_attention forward+backward (K1+K2+K3 work)",
        })
    k4, k5 = codec["K4"], codec["K5"]["flush"]["timing"]
    kernels.append({
        "name": "bf16_encode", "id": "K4", "route": "cuda", "source": CODEC_SOURCE,
        "replaces": CODEC_KERNELS["bf16_encode"][0], "launches": launches["bf16_encode"],
        "launches_lifecycle": life_launches["bf16_encode"], "launches_protocols": protocol_launches("bf16_encode"),
        "launches_models": model_launches("bf16_encode"), "launches_trainer_modes": mode_launches("bf16_encode"),
        "launches_faults": fault_launches("bf16_encode"), "launches_wires": wire_launches("bf16_encode"),
        "launches_mesh": mesh_launches("bf16_encode"),
        "max_abs_err": codec["encode_max_abs_err"], "n": k4["n"], "ms": k4["ms"], "ms_method": k4["ms_method"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"], "library_call": k4["library_call"],
    })
    kernels.append({
        "name": "bf16_fold_chunks", "id": "K5", "route": "cuda", "source": CODEC_SOURCE,
        "replaces": CODEC_KERNELS["bf16_fold_chunks"][0], "launches": launches["bf16_fold_chunks"],
        "launches_lifecycle": life_launches["bf16_fold_chunks"], "launches_models": model_launches("bf16_fold_chunks"),
        "launches_trainer_modes": mode_launches("bf16_fold_chunks"), "launches_faults": fault_launches("bf16_fold_chunks"),
        "launches_wires": wire_launches("bf16_fold_chunks"), "launches_mesh": mesh_launches("bf16_fold_chunks"),
        "max_abs_err": max(k5["max_abs_err"], codec["fold_max_abs_err"]),
        "per": f"staged flush of {k5['chunks']} chunks of 1 MiB ({k5['distinct_tiles']} tiles)",
        "ms": k5["device_ms"], "ms_method": "profiler device time of bf16_fold_kernel per flush",
        "wrapper_ms": k5["wrapper_ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"], "library_call": k5["library_call"],
        "chunk_ms": codec["K5"]["chunk"]["ms"],
    })
    flag = ring[("flagship", 2)]
    for kname, (replaces, kid) in RING_KERNELS.items():
        r = flag["timing"]["K6" if kid == "K6" else "K7"]
        key = "ring_fold_vs_plain" if kid == "K6" else "ring_allgather_vs_plain"
        checks = [row[key] for row in ring.values()] + [row["stepwise"][key] for row in ring.values()
                                                        if "stepwise" in row]
        kernels.append({
            "name": kname, "id": kid, "route": "cuda", "source": RING_SOURCE, "replaces": replaces,
            "launches": launches[kname], "launches_models": model_launches(kname),
            "launches_trainer_modes": mode_launches(kname), "launches_faults": fault_launches(kname),
            "launches_wires": wire_launches(kname), "launches_mesh": mesh_launches(kname),
            "max_abs_err": max(c["max_abs_err"] for rows in checks for c in rows),
            "nd": 2, "cross_card": flag["cross_card"],
            "design": "stepwise, across cards" if flag["cross_card"] else "one launch, every rank on one card",
            "ms": r["ms"], "ms_method": "CUDA events around the wrapper's call", "device_ms": r["device_ms"],
            **{key: r[key] for key in ("device_ms_method", "device_ms_profiler", "device_ms_same_flush",
                                       "launches_per_flush", "launches_per_result", "not_kept") if key in r},
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_call": r["library_call"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-swarm-child"]:  # a volunteer of phase 33
        sys.exit(mesh_swarm_child(sys.argv[2], sys.argv[4:]))
    sys.exit(main())
