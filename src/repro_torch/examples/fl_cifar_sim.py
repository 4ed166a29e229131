"""End-to-end driver — the paper's §III experiment (PFedDST against a
baseline), the port's twin of the reference's `examples/fl_cifar_sim.py`:
the same flags with the same defaults, plus `--device`.

Default: reduced ResNet, 12 clients, 30 rounds, PFedDST and the
random-selection ablation, on the card (`--device cpu` runs the plain
versions on the host):

    PYTHONPATH=src python -m repro_torch.examples.fl_cifar_sim

Paper-scale analogue: the FULL ResNet-18 (11 M parameters, bf16) at 16
clients × 60 rounds, every §III-A hyper-parameter kept (lr 0.1, momentum
0.9, wd 0.005, batch 128, K_e=5, K_h=1, 2 classes a client):

    PYTHONPATH=src python -m repro_torch.examples.fl_cifar_sim --paper-scale

`--chunk-rounds N` (default 5, or 1 under `--trace-stages`) runs up to N
rounds at a time through `engine.make_multi_round` (chunks end at every
eval point, every 5 rounds): no fence between a chunk's rounds, its
metrics come to the host in one copy. Results are bit for bit those of
`--chunk-rounds 1`; only the walls differ.

Network model (`repro_torch.comms`), device heterogeneity and semi-async
rounds (`repro_torch.fl.hetero`) and the open world
(`repro_torch.openworld`) take the reference's flags:

    PYTHONPATH=src python -m repro_torch.examples.fl_cifar_sim \\
        --topology ring --link-model hetero
    PYTHONPATH=src python -m repro_torch.examples.fl_cifar_sim \\
        --strategies pfeddst pfeddst_async \\
        --device-profile bimodal --straggler-fraction 0.5 \\
        --deadline 1.2 --staleness-alpha 0.5
    PYTHONPATH=src python -m repro_torch.examples.fl_cifar_sim \\
        --strategies pfeddst dfedavgm --adversary-fraction 0.25 \\
        --attack sign_flip --defense trimmed_mean \\
        --churn-join 0.05 --churn-leave 0.05
"""
from __future__ import annotations

import argparse

from repro_torch.comms.topology import TOPOLOGIES
from repro_torch.configs import get_config
from repro_torch.configs.base import (
    ChurnConfig,
    CommsConfig,
    DeviceProfile,
    FLConfig,
    ThreatConfig,
)
from repro_torch.data.synthetic import client_datasets_cifar
from repro_torch.device import resolve_device
from repro_torch.fl import run_experiment
from repro_torch.kernels.build import BUILD_DIR
from repro_torch.openworld import threat_state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper-scale", action="store_true")
    ap.add_argument("--strategies", nargs="*",
                    default=["pfeddst", "pfeddst_random"])
    ap.add_argument("--topology", default="full", choices=list(TOPOLOGIES),
                    help="communication graph (repro_torch.comms); 'full' "
                         "= the paper's all-pairs equal-cost network")
    ap.add_argument("--link-model", default="uniform",
                    choices=["uniform", "hetero", "geometric"])
    ap.add_argument("--p-link-drop", type=float, default=0.0)
    ap.add_argument("--device-profile", default=None,
                    choices=["uniform", "bimodal", "zipf"],
                    help="device capability family (repro_torch.fl."
                         "hetero); omit for the paper's homogeneous fleet")
    ap.add_argument("--straggler-fraction", type=float, default=0.25,
                    help="bimodal profile: fraction of slow devices")
    ap.add_argument("--straggler-slowdown", type=float, default=4.0,
                    help="bimodal profile: slow-device slowdown factor")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="semi-async round deadline in simulated seconds "
                         "(0 = no deadline / synchronous rounds)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="(1+lag)^(-alpha) staleness discount for "
                         "semi-async aggregation")
    # --- open world (repro_torch.openworld) ---------------------------------
    ap.add_argument("--adversary-fraction", type=float, default=0.0,
                    help="fraction of clients that are adversarial "
                         "(0 = everyone honest)")
    ap.add_argument("--attack", default="none",
                    choices=["none", "sign_flip", "gaussian", "scale"],
                    help="byzantine update corruption the adversaries run")
    ap.add_argument("--attack-scale", type=float, default=1.0,
                    help="sign_flip/scale delta multiplier")
    ap.add_argument("--noise-std", type=float, default=1.0,
                    help="gaussian attack noise std")
    ap.add_argument("--score-game", default="none",
                    choices=["none", "header", "cost", "both"],
                    help="Eq. 7/9 score-integrity gaming: spoof the "
                         "published header and/or claim the best link cost")
    ap.add_argument("--defense", default="none",
                    choices=["none", "trimmed_mean", "median", "norm_clip"],
                    help="robust aggregation replacing the mean")
    ap.add_argument("--trim-fraction", type=float, default=0.2,
                    help="trimmed_mean: fraction cut from each tail")
    ap.add_argument("--clip-factor", type=float, default=2.0,
                    help="norm_clip: clip norms to factor x median")
    ap.add_argument("--churn-join", type=float, default=0.0,
                    help="per-round join probability of each dead slot")
    ap.add_argument("--churn-leave", type=float, default=0.0,
                    help="per-round leave probability of each alive client")
    ap.add_argument("--init-alive", type=float, default=1.0,
                    help="fraction of slots alive at round 0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=0,
                    help="override the number of federated rounds "
                         "(0 = scale default: 30 reduced / 60 paper-scale)")
    ap.add_argument("--trace-out", default=None,
                    help="write a schema-versioned JSONL round trace "
                         "(repro_torch.obs) here; with several strategies "
                         "the strategy name is suffixed onto the filename")
    ap.add_argument("--trace-stages", action="store_true",
                    help="prepend a per-stage first/steady profile to the "
                         "trace (runs 2 extra fenced rounds on throwaway "
                         "state)")
    ap.add_argument("--trace-edges", action="store_true",
                    help="embed per-round selected-edge lists in the "
                         "trace's round records")
    ap.add_argument("--compile-cache", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="kept so both drivers take the same argv; the "
                         "port has no XLA compile to cache and DIR is not "
                         "used. Prints the directory where the CUDA "
                         "kernels' nvcc builds persist across processes")
    ap.add_argument("--chunk-rounds", type=int, default=None,
                    help="run up to N rounds per chunk (engine."
                         "make_multi_round): no fence between a chunk's "
                         "rounds, its metrics read back in one copy; "
                         "fixed-seed results are bitwise identical either "
                         "way. Default: eval_every (5), or 1 when "
                         "--trace-stages is set")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def build_run(args) -> dict:
    """The run the flags describe: model config, FLConfig, rounds, data
    sizes, chunk size and the threat's honest eval mask (None unless an
    adversary cast exists)."""
    chunk_rounds = args.chunk_rounds
    if chunk_rounds is None:
        chunk_rounds = 1 if args.trace_stages else 5
    comms = CommsConfig(
        topology=args.topology, link_model=args.link_model,
        p_link_drop=args.p_link_drop, graph_seed=args.seed,
        # with a finite deadline, stale peers serve their last published
        # version (the versioned peer store) instead of dropping out
        stale_mode="serve" if args.deadline > 0 else "drop")
    profile = None
    if args.device_profile is not None:
        profile = DeviceProfile(
            family=args.device_profile,
            straggler_fraction=args.straggler_fraction,
            straggler_slowdown=args.straggler_slowdown, seed=args.seed)
    threat = churn = None
    if args.adversary_fraction > 0 or args.defense != "none":
        threat = ThreatConfig(
            adversary_fraction=args.adversary_fraction, attack=args.attack,
            attack_scale=args.attack_scale, noise_std=args.noise_std,
            score_game=args.score_game, defense=args.defense,
            trim_fraction=args.trim_fraction, clip_factor=args.clip_factor,
            seed=args.seed)
    if args.churn_join > 0 or args.churn_leave > 0 or args.init_alive < 1:
        churn = ChurnConfig(join_rate=args.churn_join,
                            leave_rate=args.churn_leave,
                            init_alive=args.init_alive, seed=args.seed)
    hetero_kw = dict(
        device_profile=profile,
        deadline_s=args.deadline if args.deadline > 0 else float("inf"),
        staleness_alpha=args.staleness_alpha, threat=threat, churn=churn)
    if args.paper_scale:
        cfg = get_config("resnet18-cifar")          # full ResNet-18
        fl = FLConfig(num_clients=16, peers_per_round=4, batch_size=128,
                      client_sample_ratio=0.25, probe_size=16, comms=comms,
                      **hetero_kw)
        rounds, img, spc, spe = 60, 32, 120, 2
    else:
        cfg = get_config("resnet18-cifar").reduced()
        fl = FLConfig(num_clients=12, peers_per_round=4, batch_size=32,
                      client_sample_ratio=0.34, probe_size=8, comms=comms,
                      **hetero_kw)
        rounds, img, spc, spe = 30, 16, 80, 1
    if args.rounds > 0:
        rounds = args.rounds
    # under attack, report the honest clients' accuracy (what a defense
    # is supposed to protect); the full-M mean otherwise
    eval_mask = None
    ts = threat_state(threat, fl.num_clients, device="cpu")  # a host mask
    if ts is not None:
        eval_mask = ~ts.adversaries.numpy()
    return dict(cfg=cfg, fl=fl, rounds=rounds, image_size=img,
                samples_per_class=spc, steps_per_epoch=spe,
                chunk_rounds=chunk_rounds, eval_mask=eval_mask)


def main(argv=None) -> dict:
    """Run the flags' experiment for each strategy; → {strategy: History}."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)       # no card: fail before building data
    run = build_run(args)
    if args.compile_cache is not None:
        print("compilation cache: the CUDA kernels' nvcc builds persist in",
              BUILD_DIR)
    fl = run["fl"]
    data = client_datasets_cifar(
        args.seed, fl.num_clients, classes_per_client=fl.classes_per_client,
        samples_per_class=run["samples_per_class"],
        image_size=run["image_size"])

    final, hists = {}, {}
    for s in args.strategies:
        trace = args.trace_out
        if trace and len(args.strategies) > 1:
            stem, dot, ext = trace.rpartition(".")
            trace = f"{stem}.{s}.{ext}" if dot else f"{trace}.{s}"
        hist = run_experiment(
            s, run["cfg"], fl, data, num_rounds=run["rounds"], eval_every=5,
            steps_per_epoch=run["steps_per_epoch"], seed=args.seed,
            trace=trace, trace_stages=args.trace_stages,
            trace_edges=args.trace_edges, chunk_rounds=run["chunk_rounds"],
            eval_mask=run["eval_mask"], device=args.device)
        if trace:
            print(f"  trace → {trace}")
        hists[s] = hist
        final[s] = (hist.accuracy[-1], hist.comm_bytes[-1],
                    hist.net_time_s[-1], hist.device_time_s[-1])
    print(f"\nfinal personalized accuracy ({args.topology} topology, "
          f"{args.link_model} links"
          + (f", {args.device_profile} devices" if args.device_profile
             else "") + "):")
    for s, (a, b, t, d) in final.items():
        line = (f"  {s:16s} acc={a:.4f}  comm={b / 1e6:.2f}MB  "
                f"net={t:.1f}s")
        if d:
            line += f"  device={d:.1f}s"
        print(line)
    return hists


if __name__ == "__main__":
    main()
