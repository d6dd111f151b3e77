#!/usr/bin/env python
"""Volunteer of the PyTorch port (the flags of ``run_volunteer.py``).

Starts one volunteer on the card: it joins the swarm through the
coordinator's DHT, reports to the coordinator through the control plane,
restores its newest checkpoint, pulls the swarm's state from the freshest
peer ahead of it, trains the chosen model and averages with its peers in
the chosen mode. The flagship path:

    python coordinator_torch.py --port 9000
    python run_volunteer_torch.py --model gpt2_small --batch-size 8 \
        --averaging sync --wire bf16 --coordinator 127.0.0.1:9000 \
        --checkpoint-dir ckpt/vol0 --metrics vol0.jsonl

The other modes: ``--averaging gossip``; ``--averaging butterfly``, on a
20 s wall-clock cadence on the swarm's consensus clock unless
``--average-interval-s`` sets another (0 = the step cadence); and
``--averaging byzantine --method trimmed_mean --resilience`` (full-mesh
robust rounds with the phi-accrual detector, the policy and the controller).
``--average-what grads`` averages every step's gradients instead (sync or
byzantine); ``--outer-optimizer nesterov`` puts a DiLoCo-style Nesterov step
over params rounds; ``--data x.npz`` trains on a file (``experiments/
make_npz.py`` writes one) with ``--eval-every`` / ``--eval-batches`` for a
held-out eval stream; ``--steps-per-call N`` fuses up to N steps per call.
``--group-size N`` (sync, byzantine, butterfly) splits the swarm into
rotating groups of about N (``--group-rotation-s`` the rotation), and
``--zone Z --cross-zone-every-k K`` keeps every group inside one zone except
on every K-th rotation; ``--zone-shards K`` (with ``--zone`` and, when
averaging, ``--group-size``) holds one of K shards of the averaged tree per
zone member and rendezvous same-shard holders.
The wires: ``--wire f32|bf16|q8`` for params or gradients; ``--wire topk``
(``--topk-frac``, ``--topk-warmup-rounds``; under byzantine only with
``--method mean --allow-unrobust-topk``), ``--wire powersgd`` (``--psgd-rank``)
and ``--wire sign`` compress gradients (``--average-what grads``, sync or
byzantine) with error feedback; PowerSGD's power iteration runs on the card.
Config 8's Byzantine arms, for example:

    python run_volunteer_torch.py --model gpt2_small --averaging byzantine \
        --average-what grads --method trimmed_mean --method-kw trim=1 \
        --wire powersgd --psgd-rank 4 --coordinator 127.0.0.1:9000

Without ``--model`` it trains the reference's default, mnist_mlp
(capability config 1); ``--list-models`` prints the ported zoo.

On SIGTERM (a preemption notice) the volunteer stops after its current step,
saves a final checkpoint, leaves the swarm and exits 0. It prints
``VOLUNTEER_DONE`` and its summary as JSON when it ends.

Every flag has the reference's name and default. ``--device cpu`` (this
script's own flag) runs on the CPU; without it the volunteer needs a card.
A flag whose slice is not ported yet, set away from its default, exits with
status 2 and a message naming what is ported.
"""

import argparse
import json

# dest -> what it belongs to, for the flags whose slice is not ported yet.
LATER_FLAGS = {
    "seq_sharded": "sequence parallelism",
    "sp_impl": "sequence parallelism",
}


def _parse_kv(items):
    out = {}
    for kv in items:
        k, v = kv.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--list-models", action="store_true",
                    help="print the model zoo and exit")
    ap.add_argument("--model", default="mnist_mlp")
    ap.add_argument("--model-override", action="append", default=[],
                    help="key=value config override (repeatable), e.g. d_model=128")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address(es), host:port[,host:port...] — "
                         "several = several DHT bootstrap nodes; joining works "
                         "while ANY is alive")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--advertise-host", default=None,
                    help="dialable address to publish when binding 0.0.0.0")
    ap.add_argument("--checkpoint-every", type=int, default=200)
    ap.add_argument("--peer-id", default="")
    ap.add_argument("--averaging", default="none",
                    choices=["none", "sync", "gossip", "butterfly", "byzantine"])
    ap.add_argument("--average-every", type=int, default=10)
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="scan up to N train steps inside one compiled call "
                         "between cadence points (host-loop amortization; "
                         "params mode, no --mesh). 1 = off")
    ap.add_argument("--average-interval-s", type=float, default=None,
                    help="wall-clock averaging cadence in seconds (params "
                         "mode; 0 = every --average-every steps). Rounds "
                         "fire at absolute multiples of the interval, so "
                         "clock-synced heterogeneous volunteers rendezvous "
                         "within ms regardless of per-volunteer step speed; "
                         "contributions are weighted by actual window "
                         "progress. Default AUTO: butterfly params-mode "
                         "swarms (the heterogeneous config) get 20s "
                         "wall-clock cadence — step cadence is measured-"
                         "pathological there (BASELINE.md config 4 vs 4b, "
                         "scale16) — every other mode keeps step cadence; "
                         "pass an explicit 0 to force step cadence")
    ap.add_argument("--average-what", default="params", choices=("params", "grads"),
                    help="params = local-SGD periodic averaging; grads = GradientAverager")
    ap.add_argument("--wire", default="f32",
                    choices=("f32", "bf16", "q8", "topk", "powersgd", "sign"),
                    help="WAN payload codec; bf16 halves DCN traffic, q8 "
                         "quarters it (chunked int8, <=0.4%% element error), "
                         "topk ships only the largest-magnitude gradient "
                         "entries with error feedback (grads mode, "
                         "sync/byzantine; ~50x fewer bytes at default frac), "
                         "powersgd ships rank-r factor pairs per tensor "
                         "(grads mode, sync/byzantine; composes with robust "
                         "methods, unlike topk), sign ships 1-bit EF-signSGD "
                         "gradients (~32x fewer push bytes; q8 results; "
                         "grads mode, sync/byzantine; composes with robust "
                         "methods)")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="fraction of gradient entries kept per round by "
                         "--wire topk")
    ap.add_argument("--topk-warmup-rounds", type=int, default=0,
                    help="ramp the topk kept fraction from dense to "
                         "--topk-frac over the first N successful rounds "
                         "(DGC-style sparsity warmup; 0 = off)")
    ap.add_argument("--psgd-rank", type=int, default=4,
                    help="target rank for --wire powersgd (per->=2D-tensor "
                         "low-rank factor pairs; higher = more bytes, less "
                         "truncation)")
    ap.add_argument("--allow-unrobust-topk", action="store_true",
                    help="permit --averaging byzantine with --wire topk, "
                         "which runs a plain weighted mean (no Byzantine "
                         "tolerance); otherwise that combination is refused")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction, default=True,
                    help="overlap WAN averaging rounds with local compute "
                         "(params mode; --no-overlap restores blocking rounds)")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="drop an overlapped round's result if it lags more "
                         "than this many steps (0 = no bound)")
    ap.add_argument("--min-group", type=int, default=2)
    ap.add_argument("--max-group", type=int, default=16)
    ap.add_argument("--group-size", type=int, default=0,
                    help="multi-group round scheduling (Moshpit-style): "
                         "partition the live swarm into many groups of "
                         "~this size per round via a rotating seeded hash "
                         "grid over the DHT keyspace, so sync throughput "
                         "is no longer capped by one leader's NIC; group "
                         "averages mix globally in O(log N) rounds. 0 = "
                         "off (one group per epoch). sync/byzantine/"
                         "butterfly only")
    ap.add_argument("--group-rotation-s", type=float, default=0.0,
                    help="rotation cadence of the group schedule, seconds "
                         "(0 = auto: the wall-clock averaging interval "
                         "when set, else 15s)")
    ap.add_argument("--zone", default="",
                    help="locality zone this volunteer advertises (e.g. "
                         "dc-eu1, home-us): volunteers in one zone share "
                         "fast links; the hierarchical schedule groups "
                         "intra-zone every rotation and only crosses zones "
                         "every --cross-zone-every-k rotations. Empty = "
                         "unzoned (flat scheduling)")
    ap.add_argument("--cross-zone-every-k", type=int, default=0,
                    help="hierarchical scheduling cadence: with "
                         "--group-size and >= 2 advertised zones live, "
                         "every k-th rotation runs the zone-blind CROSS-"
                         "zone mixing grid and the rest stay INTRA-zone "
                         "(those rounds move zero cross-zone bytes; group "
                         "means still reach the global mean in O(log N) "
                         "rounds per level, Moshpit-style). 0 = flat "
                         "single-level grid; degrades to flat while fewer "
                         "than two zones are advertised")
    ap.add_argument("--zone-shards", type=int, default=0,
                    help="zone-sharded training: partition the averaged "
                         "parameter tree into K zone-local shards — this "
                         "volunteer holds its HRW-assigned shard(s), "
                         "advertises its primary shard so cross-zone "
                         "rotations average only same-shard holders "
                         "(~1/K wire bytes per round), and re-shards with "
                         "generation fencing + hedged recovery on zone "
                         "churn. Requires --zone; with averaging, also "
                         "--group-size. 0 = unsharded (full replica)")
    ap.add_argument("--method", default="trimmed_mean",
                    help="byzantine estimator: trimmed_mean|median|krum|"
                         "geometric_median|bulyan|centered_clip")
    ap.add_argument("--method-kw", action="append", default=[],
                    help="estimator keyword override, key=value (repeatable; "
                         "values JSON-parsed) — e.g. --method-kw n_byzantine=2 "
                         "for krum/bulyan, --method-kw trim=2, "
                         "--method-kw clip_tau=0.5")
    ap.add_argument("--batch-size", type=int, default=32,
                    help="samples per optimizer step (split across --accum-steps)")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient-accumulation microbatches inside the compiled "
                         "step; lets slow/small volunteers train the same "
                         "effective batch in less HBM")
    ap.add_argument("--mesh", default="",
                    help="device mesh spec over this volunteer's local "
                         "cards, e.g. dp=2,tp=2 or ep=2,tp=2 (dp, tp and ep "
                         "are ported): the step is sharded over them by the "
                         "partition rules (with --device cpu every rank is "
                         "the CPU); empty = single device")
    ap.add_argument("--mesh-codec", default="auto", choices=("auto", "mesh", "host"),
                    help="swarm data-path backend: run the bf16 wire codec "
                         "and the leader's tile folds as CUDA kernels on the "
                         "volunteer's cards (auto = the cards when the "
                         "volunteer trains on them, host numpy on the CPU)")
    ap.add_argument("--mesh-collective", default="auto",
                    choices=("auto", "ring", "off"),
                    help="fused reduce pipeline for leader mean folds: ring "
                         "reduce-scatter kernel that decodes, folds, and "
                         "forwards wire tiles in one device pass over the "
                         "codec mesh (auto = ring with >= 2 CUDA ranks, "
                         "staged path otherwise)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard params+optimizer over the mesh's dp "
                         "axis (weights, grads, opt state at 1/dp per chip)")
    ap.add_argument("--seq-sharded", action="store_true",
                    help="shard the sequence dim over the mesh's sp axis "
                         "(long-context path)")
    ap.add_argument("--sp-impl", default="ring", choices=("ring", "ulysses"),
                    help="sequence-parallel implementation: ring (ppermute "
                         "K/V rotation, any head count) or ulysses "
                         "(all-to-all seq<->heads; needs n_heads %% sp == 0)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable the telemetry plane (round tracing, "
                         "unified metrics registry, flight recorder): every "
                         "record path becomes a no-op; the telemetry.* RPCs "
                         "still answer with empty views (implies "
                         "--no-health-probe)")
    ap.add_argument("--no-health-probe", action="store_true",
                    help="disable the training-health layer only "
                         "(post-round parameter sketches / live mixing "
                         "error, gradient-mass accounting, per-peer "
                         "contribution quality, codec distortion gauges): "
                         "no sketch bytes ride the heartbeat report; the "
                         "rest of the telemetry plane stays on")
    ap.add_argument("--no-watchdog", action="store_true",
                    help="disable the swarm watchdog only (streaming "
                         "anomaly detectors: commit-rate collapse, round-"
                         "wall inflation per level, mass-fraction drops, "
                         "bandwidth collapse, beat-failure streaks, "
                         "quality-flag alerts): no alert bytes ride the "
                         "heartbeat report; tracing and the health probe "
                         "stay on")
    ap.add_argument("--no-hedge", action="store_true",
                    help="disable tail-optimal hedged recovery when this "
                         "volunteer leads streaming rounds (soft-deadline "
                         "sync.refetch re-requests for predicted-late tile "
                         "ranges): restores pure deadline-drop semantics")
    ap.add_argument("--tail-redundancy-frac", type=float, default=0.0,
                    help="summand redundancy for the last k%% of tiles: "
                         "each contribution's tail rides XOR-coded on its "
                         "ring successor's sidecar, decoded by the leader "
                         "only if the original misses commit (0 = off)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve GET /metrics in Prometheus text format on "
                         "this local port (0 = off): any stock scraper can "
                         "watch this volunteer without the coordinator")
    ap.add_argument("--host-replica", action="store_true",
                    help="host a control-plane replica on this volunteer: "
                         "serve coord.status and batched heartbeat/report "
                         "traffic and stand for election into the "
                         "key-range-sharded replica set — with a few of "
                         "these, coordinator death is a non-event "
                         "(volunteers fail over to a surviving replica "
                         "within one heartbeat)")
    ap.add_argument("--secret-file", default=None,
                    help="file holding the shared swarm secret; enables "
                         "HMAC frame authentication (must match the "
                         "coordinator's and every peer's)")
    ap.add_argument("--data", default=None,
                    help=".npz of aligned arrays (keys = the model's batch schema); default synthetic")
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0,
                    help="per-volunteer seed (data order + step rng)")
    ap.add_argument("--param-dtype", default=None,
                    help="cast floating params to this dtype after init "
                         "(e.g. bfloat16: halves param/optimizer memory, "
                         "tensor-core rate). Part of the averaging schema, so every "
                         "volunteer on a task must use the same dtype — a "
                         "mismatch refuses rounds rather than corrupting them")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="TASK-constant seed for the initial params; must match "
                         "across the swarm (for LoRA it pins the shared frozen base)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--target-loss", type=float, default=None)
    ap.add_argument("--target-mode", default="stop", choices=("stop", "record"),
                    help="stop: end the run at --target-loss; record: train "
                         "the full --steps and report when the target was "
                         "first crossed (time-to-target-loss)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out eval cadence in steps (0 = off); mean "
                         "loss over --eval-batches recorded as an 'eval' "
                         "metrics event")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--join-timeout", type=float, default=10.0)
    ap.add_argument("--gather-timeout", type=float, default=20.0)
    ap.add_argument("--outer-optimizer", default="none", choices=("none", "nesterov"),
                    help="DiLoCo-style outer optimizer over params-mode "
                         "averaging rounds: Nesterov momentum on the "
                         "per-round aggregate delta (better convergence per "
                         "round at the same WAN bytes)")
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--outer-momentum", type=float, default=0.9)
    ap.add_argument("--adaptive-timeout", action="store_true",
                    help="bound round waits by an EWMA of successful round "
                         "times (dead peers cost seconds, not the full "
                         "gather budget); --gather-timeout stays the ceiling")
    ap.add_argument("--resilience", action="store_true",
                    help="adaptive resilience layer: phi-accrual liveness "
                         "(straggler pre-exclusion at group formation) plus "
                         "the policy engine that learns round deadlines, "
                         "backs off retries after failures, and escalates "
                         "the robust estimator on rejection evidence "
                         "(docs/RESILIENCE.md)")
    ap.add_argument("--no-adapt", action="store_true",
                    help="disable the closed-loop adaptive controller "
                         "(swarm/controller.py): topology, dense-wire, "
                         "cross-zone-cadence, per-level-deadline, and "
                         "hedge-regime decisions stay at their configured "
                         "static values end-to-end, and no controller "
                         "section rides the report beat. Only meaningful "
                         "with --resilience (the controller rides its "
                         "policy engine)")
    ap.add_argument("--phi-threshold", type=float, default=8.0,
                    help="suspicion threshold for the phi-accrual detector "
                         "(8 ~ one-in-1e8 false-positive odds under the "
                         "fitted heartbeat model; lower = more aggressive "
                         "pre-exclusion)")
    ap.add_argument("--round-deadline-s", type=float, default=0.0,
                    help="static wall-clock budget per averaging round, "
                         "seconds: the leader stamps clock()+budget into "
                         "the round begin and the whole group COMMITS at "
                         "that instant with the contributions that arrived "
                         "(re-weighted mean over the subset). 0 = use "
                         "--gather-timeout; --resilience supersedes both "
                         "with its learned deadline")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the volunteer trains: the card (default; "
                         "exits when there is none) or the CPU")
    args = ap.parse_args()

    def refuse(msg: str) -> None:
        ap.exit(2, f"{ap.prog}: error: {msg}\n")

    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.models.registry import ported_models
    from distributedvolunteercomputing_tpu_torch.swarm.volunteer import (
        PORTED,
        VolunteerConfig,
        run_volunteer,
    )

    if args.list_models:
        for name in ported_models():
            print(name)
        return
    for dest, what in LATER_FLAGS.items():
        if getattr(args, dest) != ap.get_default(dest):
            refuse(f"--{dest.replace('_', '-')} ({what}) is not ported yet; ported: {PORTED}")
    overrides = _parse_kv(args.model_override)
    method_kw = _parse_kv(args.method_kw)
    try:
        get_model(args.model, **overrides)
    except KeyError as e:
        refuse(str(e.args[0]))
    try:
        cfg = VolunteerConfig(
            model=args.model,
            model_overrides=overrides,
            coordinator=args.coordinator,
            host=args.host,
            port=args.port,
            advertise_host=args.advertise_host,
            peer_id=args.peer_id,
            averaging=args.averaging,
            average_every=args.average_every,
            average_interval_s=args.average_interval_s,
            steps_per_call=args.steps_per_call,
            average_what=args.average_what,
            wire=args.wire,
            topk_frac=args.topk_frac,
            topk_warmup_rounds=args.topk_warmup_rounds,
            powersgd_rank=args.psgd_rank,
            allow_unrobust_topk=args.allow_unrobust_topk,
            overlap=args.overlap,
            max_staleness=args.max_staleness,
            min_group=args.min_group,
            max_group=args.max_group,
            group_size=args.group_size,
            group_rotation_s=args.group_rotation_s,
            zone=args.zone,
            cross_zone_every_k=args.cross_zone_every_k,
            zone_shards=args.zone_shards,
            batch_size=args.batch_size,
            accum_steps=args.accum_steps,
            mesh=args.mesh,
            fsdp=args.fsdp,
            mesh_codec=args.mesh_codec,
            mesh_collective=args.mesh_collective,
            host_replica=args.host_replica,
            secret_file=args.secret_file,
            data_path=args.data,
            optimizer=args.optimizer,
            lr=args.lr,
            seed=args.seed,
            init_seed=args.init_seed,
            param_dtype=args.param_dtype,
            steps=args.steps,
            target_loss=args.target_loss,
            target_mode=args.target_mode,
            eval_every=args.eval_every,
            eval_batches=args.eval_batches,
            metrics_path=args.metrics,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            join_timeout=args.join_timeout,
            gather_timeout=args.gather_timeout,
            method=args.method,
            method_kw=method_kw or None,
            adaptive_timeout=args.adaptive_timeout,
            resilience=args.resilience,
            adapt=not args.no_adapt,
            phi_threshold=args.phi_threshold,
            round_deadline_s=args.round_deadline_s,
            outer_optimizer=args.outer_optimizer,
            outer_lr=args.outer_lr,
            outer_momentum=args.outer_momentum,
            telemetry=not args.no_telemetry,
            health_probe=not (args.no_telemetry or args.no_health_probe),
            watchdog=not (args.no_telemetry or args.no_watchdog),
            hedge=not args.no_hedge,
            tail_redundancy_frac=args.tail_redundancy_frac,
            metrics_port=args.metrics_port,
            device=args.device,
        )
    except NotImplementedError as e:
        refuse(str(e))
    summary = run_volunteer(cfg)
    print("VOLUNTEER_DONE " + json.dumps(summary, default=str), flush=True)


if __name__ == "__main__":
    main()
