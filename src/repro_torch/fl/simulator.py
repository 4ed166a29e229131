"""Population FL simulator — round loop + personalized evaluation,
reference `repro.fl.simulator`: a per-round loop, or chunks of rounds
(`run_experiment(chunk_rounds=)`, `engine.chain_rounds`) whose
stacked metrics are unstacked into the same per-round bookkeeping.

Personalized test accuracy = mean over clients of client i's model on
client i's OWN test split (the paper's primary metric); FedBABU's
evaluation first fine-tunes a throwaway header copy per client
(`_finetune_heads`).

When the strategy carries a comms fabric (`FLConfig.comms`, the default)
every round's exchange is priced on the simulated network by
`fabric.account_round` after the round's timed wall: `History` gets
per-round bytes, simulated network time and staleness, and cumulative
bytes, network time and energy at each eval point. `FLConfig(comms=None)`
is the paper's costless scalar world: those fields stay zero. Only
parameter traffic is priced.

Under a `FLConfig.device_profile`, `History` also gets the simulated
device wall-clock: pfeddst_async's rounds report their deadline-capped
duration (`round_wall_s` from the gate), a synchronous round stalls on
its slowest participant. Without a profile those columns stay zero.

Under `fl.threat` or `fl.churn` the strategy runs wrapped by the open
world (`openworld.make_open_spec`); `eval_mask` restricts the reported
accuracy to a set of clients (the honest cast, say), and the trace's
selection graph carries the adversary cast.

`trace=` writes the reference's schema-v1 JSONL round trace
(`obs.trace`): a header, optionally a stage profile (`trace_stages`: 2
instrumented rounds on throwaway state), one record per round, the
cumulative selection graph and a summary.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.comms.transport import payload_bytes_per_client
from repro_torch.core.client_state import client_rows, stack_trees
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.data.pipeline import as_index_tensor
from repro_torch.device import resolve_device
from repro_torch.fl.engine import (
    chain_rounds,
    make_round,
    metrics_to_host,
    named_streams,
    unstack_metrics,
)
from repro_torch.fl.hetero import local_wall_times, sample_device_vectors
from repro_torch.fl.strategies import local_train_steps, make_strategy
from repro_torch.models import model as model_mod
from repro_torch.models.split import merge_params, split_params
from repro_torch.obs.registry import scalar_metrics
from repro_torch.obs.selection_probe import SelectionGraph
from repro_torch.obs.timers import (
    RoundClock,
    StageTimes,
    fence,
    instrument_stages,
)
from repro_torch.obs.trace import (
    TraceWriter,
    header_record,
    round_record,
    score_block,
    stage_profile_record,
    summary_record,
)
from repro_torch.openworld import threat_state
from repro_torch.optim.sgd import sgd

FT_STREAM_KEY = 1 << 20   # keys eval-time fine-tune draws apart from rounds
PROFILE_STREAM_KEY = 1 << 21   # keys the stage profile's rounds apart


def _batch_for(cfg, x, y) -> dict:
    """A batch of `cfg`'s family: {"images", "labels"} for the cnn,
    {"tokens"} for an LLM (y unused: next-token targets)."""
    if cfg.family == "cnn":
        return {"images": x, "labels": y}
    return {"tokens": x}


@torch.no_grad()
def evaluate_population(cfg, params, test_x, test_y):
    """Mean + per-client personalized test accuracy (next-token accuracy
    for an LLM). params: leading-M."""
    m = test_x.shape[0]
    accs = torch.stack([
        model_mod.accuracy(cfg, client_rows(params, i),
                           _batch_for(cfg, test_x[i], test_y[i]))
        for i in range(m)])
    return accs.mean(), accs


def _finetune_heads(cfg, fl, params: dict, train_x, train_y, generator,
                    steps: int = 8, *, idx=None) -> dict:
    """FedBABU-style eval-time personalization: `steps` phase-h steps on a
    throwaway header copy per client (fresh optimizer state, batches of
    the client's own training data), one client at a time; the real
    state is left untouched. idx (steps, M, B) replaces the batch draws.
    → merged leading-M params."""
    opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
    phase = make_phase_steps(cfg, opt)
    m, n = train_x.shape[:2]
    if idx is None:
        idx = torch.randint(0, n, (steps, m, fl.batch_size),
                            generator=generator)
    idx = as_index_tensor(idx, train_x.device)
    out = []
    for i in range(m):
        e, h = split_params(cfg, client_rows(params, i))
        o = opt.init(h)
        for s in range(steps):
            b = idx[s, i]
            h, o, _ = phase.phase_h(e, h, o, _batch_for(
                cfg, train_x[i][b], train_y[i][b]))
        out.append(merge_params(e, h))
    return stack_trees(out)


@dataclass
class History:
    """Experiment trace; `to_dict` keeps the reference's schema
    (docs/architecture.md, "History schema"). `wall_s` is the steady
    wall (rounds 1..) at each eval point; round 0's wall is `compile_s`.
    `extra` holds every scalar a stage records, per round."""
    rounds: list = field(default_factory=list)
    accuracy: list = field(default_factory=list)
    train_loss: list = field(default_factory=list)
    wall_s: list = field(default_factory=list)
    compile_s: float = 0.0
    round_bytes: list = field(default_factory=list)
    round_net_time_s: list = field(default_factory=list)
    round_stale_lag: list = field(default_factory=list)
    round_stale_max: list = field(default_factory=list)
    comm_bytes: list = field(default_factory=list)
    net_time_s: list = field(default_factory=list)
    energy_j: list = field(default_factory=list)
    round_device_wall_s: list = field(default_factory=list)
    round_straggler_wall_s: list = field(default_factory=list)
    round_eff_lag: list = field(default_factory=list)
    device_time_s: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)

    def to_dict(self):
        return {
            "rounds": self.rounds,
            "accuracy": [float(a) for a in self.accuracy],
            "train_loss": [float(x) for x in self.train_loss],
            "wall_s": [float(w) for w in self.wall_s],
            "compile_s": float(self.compile_s),
            "round_bytes": [int(b) for b in self.round_bytes],
            "round_net_time_s": [float(t) for t in self.round_net_time_s],
            "round_stale_lag": [float(s) for s in self.round_stale_lag],
            "round_stale_max": [int(s) for s in self.round_stale_max],
            "comm_bytes": [int(b) for b in self.comm_bytes],
            "net_time_s": [float(t) for t in self.net_time_s],
            "energy_j": [float(e) for e in self.energy_j],
            "round_device_wall_s": [
                float(t) for t in self.round_device_wall_s],
            "round_straggler_wall_s": [
                float(t) for t in self.round_straggler_wall_s],
            "round_eff_lag": [float(s) for s in self.round_eff_lag],
            "device_time_s": [float(t) for t in self.device_time_s],
            "extra": {name: [float(v) for v in vals]
                      for name, vals in self.extra.items()},
        }

    def rounds_to_target(self, target: float):
        """First eval round reaching `target` accuracy (None if never)."""
        for r, a in zip(self.rounds, self.accuracy):
            if a >= target:
                return r
        return None

    def bytes_to_target(self, target: float):
        """Cumulative comm bytes when `target` accuracy is first reached
        (None if never)."""
        for a, b in zip(self.accuracy, self.comm_bytes):
            if a >= target:
                return b
        return None


def _stale_summary(stale) -> tuple:
    """(mean lag over the stale clients, max lag); 0s when nobody is
    stale. The mean leaves the fresh clients' zeros out, so it tracks the
    lag distribution, not p_stale."""
    if stale is None:
        return 0.0, 0
    arr = stale.cpu().numpy() if isinstance(stale, torch.Tensor) \
        else np.asarray(stale)
    lagging = arr[arr > 0]
    if lagging.size == 0:
        return 0.0, 0
    return float(lagging.mean()), int(arr.max())


def _message_bytes(strat, cfg, fl, state) -> int:
    """Wire size of one message of `strat` (0 without a fabric): the
    per-client bytes of its payload tree (the model, or the extractor),
    quantization-aware and with the per-message framing of `fl.comms`,
    times the strategy's payload fraction."""
    if strat.fabric is None:
        return 0
    params = strat.params_for_eval(state)
    tree = params if strat.payload_kind == "model" \
        else split_params(cfg, params)[0]
    payload = payload_bytes_per_client(
        tree, fl.num_clients, bits=fl.comms.payload_bits,
        overhead_bytes=fl.comms.msg_overhead_bytes)
    return int(round(payload * strat.payload_fraction))


def _profile_stages(strat, fl, train_data, seed: int, *,
                    rounds: int = 2) -> dict:
    """Per-stage first/steady profile on THROWAWAY state: `rounds`
    instrumented rounds (`obs.timers.instrument_stages`) from a fresh
    init, their own round keys and draws, so the main run's state,
    streams and network draws are untouched (its peer store included:
    the throwaway state has its own)."""
    times = StageTimes()
    spec = replace(
        strat.spec, stages=instrument_stages(strat.spec.stages, times))
    round_fn = make_round(spec, fl, strat.fabric)
    state = strat.init(seed)
    for r in range(rounds):
        state, _ = round_fn(state, train_data, (seed, PROFILE_STREAM_KEY, r))
    return times.summary()


def run_experiment(strategy_name: str, cfg, fl, data: dict, *,
                   num_rounds: int, eval_every: int = 5,
                   steps_per_epoch: int = 2, seed: int = 0,
                   verbose: bool = True, device="cuda",
                   on_round=None, trace: str | None = None,
                   trace_stages: bool = False,
                   trace_edges: bool = False, chunk_rounds: int = 1,
                   eval_mask=None) -> History:
    """data: dict(train_x, train_y, test_x, test_y), leading-M stacked
    (tensors or numpy arrays; moved to `device`): images and labels for
    the cnn, token sequences (M, N, S) for an LLM (train_y / test_y
    unused; `launch.train.build_data`).

    on_round: optional `(round_index, metrics) -> None`, called after
    each round with the round's metrics dict (arrays included, e.g.
    `select_mask`), outside the round's wall clock; under chunks, once
    per unstacked round, with the metrics on the host.

    The network comes from `fl.comms` (a `CommsConfig`: topology,
    ring_hops, hier_cluster, ..., link_model, the events p_link_drop,
    availability, p_stale, and sparse=True for the packed fabric; None
    for the costless scalar path); the device model from
    `fl.device_profile` and `fl.deadline_s`.

    trace: path of a schema-v1 JSONL round trace (`obs.trace`): one
    record per round with its wall, comm and device blocks, every
    recorded scalar metric and, when the strategy selects, the Eq. 9
    score decomposition; closed by the cumulative selection graph and a
    summary. trace_stages adds a 2-round stage profile on throwaway state
    (`_profile_stages`); trace_edges embeds each round's selected edges.
    With trace=None the run is unchanged.

    chunk_rounds > 1 runs the rounds in chunks (`engine.chain_rounds` of
    the strategy's round function, the one the per-round loop calls; one
    per distinct chunk size): a chunk's rounds run with no fence between
    them, its stacked metrics come to the host in one copy and
    are unstacked into the per-round bookkeeping (History, trace records,
    on_round). Chunks end at every eval boundary, so evaluation sees the
    state right after its round. Round r is keyed (seed, r) either way,
    so every History field but the walls, and every trace record but its
    wall and compile flag, equals the per-round run's. `History.compile_s`
    then covers the first chunk, whose trace records carry compile=True.
    chunk_rounds=1 is the per-round loop.

    eval_mask: optional (M,) bool restricting the reported personalized
    accuracy to these clients' mean (NaN when it selects none); None
    keeps the full-M mean."""
    device = resolve_device(device)
    strat = make_strategy(strategy_name, cfg, fl, steps_per_epoch,
                          device=device)
    data = {k: torch.as_tensor(v).to(device) for k, v in data.items()}
    train_data = _batch_for(cfg, data["train_x"], data["train_y"])
    state = strat.init(seed)

    payload = _message_bytes(strat, cfg, fl, state)
    # per-client round wall-times of a synchronous strategy under a
    # device profile (pfeddst_async's gate reports its own through the
    # metrics); the same step count prices pfeddst_async's runtime
    wall_np = None
    if fl.device_profile is not None:
        devices = sample_device_vectors(fl.device_profile, fl.num_clients)
        wall_np = local_wall_times(
            devices, local_train_steps(strategy_name, fl, steps_per_epoch),
            fl.device_profile)

    tracer = graph = None
    if trace is not None:
        tracer = TraceWriter(trace)
        tracer.write(header_record(
            strategy=strategy_name, num_clients=fl.num_clients,
            num_rounds=num_rounds, seed=seed, family=cfg.family,
            eval_every=eval_every))
        ts = threat_state(fl.threat, fl.num_clients, device)
        graph = SelectionGraph(
            fl.num_clients, adversaries=None if ts is None
            else ts.adversaries.cpu().numpy())
        if trace_stages:
            tracer.write(stage_profile_record(_profile_stages(
                strat, fl, train_data, seed)))

    hist = History()
    clock = RoundClock()
    cum_bytes, cum_net_s, cum_energy, cum_device_s = 0, 0.0, 0.0, 0.0
    t_start = time.time()

    def consume_round(r, metrics, *, compile_round: bool):
        """The host's bookkeeping of round r, after its timed wall: fabric
        accounting, History, eval, trace record. The same for the
        per-round and the chunked (unstacked) loop."""
        nonlocal cum_bytes, cum_net_s, cum_energy, cum_device_s
        # the accounting reads the round's edges on the host
        if strat.fabric is not None:
            stats = strat.fabric.account_round(strat.comm_pattern, metrics,
                                               payload, name=strat.name)
            round_bytes, round_net_s = stats.total_bytes, stats.sim_time_s
            round_energy = stats.energy_j
        else:
            round_bytes, round_net_s, round_energy = 0, 0.0, 0.0
        cum_bytes += round_bytes
        cum_net_s += round_net_s
        cum_energy += round_energy
        mean_lag, max_lag = _stale_summary(metrics.get("stale"))
        # simulated device wall-clock: a semi-async round reports its
        # deadline-capped duration; a synchronous round under a device
        # profile stalls on its slowest participant
        round_wall = metrics.get("round_wall_s")
        if round_wall is not None:
            round_wall = float(round_wall)
            straggler = float(metrics.get("straggler_wall_s", round_wall))
        elif wall_np is not None:
            act = metrics["active"].cpu().numpy()
            straggler = float(wall_np[act].max()) if act.any() else 0.0
            round_wall = straggler
        else:
            round_wall = straggler = 0.0
        eff = metrics.get("eff_lag_mean")
        eff_lag = float(eff) if eff is not None else 0.0
        cum_device_s += round_wall
        for lst, value in ((hist.round_bytes, round_bytes),
                           (hist.round_net_time_s, round_net_s),
                           (hist.round_stale_lag, mean_lag),
                           (hist.round_stale_max, max_lag),
                           (hist.round_device_wall_s, round_wall),
                           (hist.round_straggler_wall_s, straggler),
                           (hist.round_eff_lag, eff_lag)):
            lst.append(value)
        scalars = scalar_metrics(metrics)
        for name, value in scalars.items():
            hist.extra.setdefault(name, []).append(value)
        if on_round is not None:
            on_round(r, metrics)

        eval_point = None
        if (r + 1) % eval_every == 0 or r == num_rounds - 1:
            params = strat.params_for_eval(state)
            if strat.needs_head_finetune:
                # fresh batch draws at every eval point (round in the key)
                gen = named_streams((seed, FT_STREAM_KEY, r), ("ft",))["ft"]
                params = _finetune_heads(cfg, fl, params, data["train_x"],
                                         data["train_y"], gen)
            acc, accs = evaluate_population(cfg, params, data["test_x"],
                                            data["test_y"])
            if eval_mask is not None:
                kept = accs.cpu().numpy()[np.asarray(eval_mask, bool)]
                acc = float(kept.mean()) if kept.size else float("nan")
            loss_keys = [k for k in metrics if "loss" in k]
            tl = float(np.mean([float(metrics[k]) for k in loss_keys])) \
                if loss_keys else float("nan")
            hist.rounds.append(r + 1)
            hist.accuracy.append(float(acc))
            hist.train_loss.append(tl)
            hist.wall_s.append(clock.elapsed())
            hist.comm_bytes.append(cum_bytes)
            hist.net_time_s.append(cum_net_s)
            hist.energy_j.append(cum_energy)
            hist.device_time_s.append(cum_device_s)
            eval_point = {"accuracy": float(acc), "train_loss": tl}
            if verbose:
                print(f"[{strategy_name:16s}] round {r + 1:4d} "
                      f"acc={float(acc):.4f} loss={tl:.4f} "
                      f"comm={cum_bytes / 1e6:.2f}MB net={cum_net_s:.1f}s "
                      f"({time.time() - t_start:.0f}s)", flush=True)

        if tracer is not None:
            mask = metrics.get("select_mask", metrics.get("comm_edges"))
            edges = graph.observe(mask) if mask is not None else None
            tracer.write(round_record(
                rnd=r, wall_s=clock.last_s, compile_round=compile_round,
                active=int(metrics["active"].sum()),
                stale_mean=mean_lag, stale_max=max_lag,
                comm={"bytes": round_bytes, "net_time_s": round_net_s,
                      "energy_j": round_energy},
                device={"wall_s": round_wall, "straggler_s": straggler,
                        "eff_lag": eff_lag},
                metrics=scalars, score=score_block(scalars),
                edges=sorted(edges) if (trace_edges and edges is not None)
                else None,
                eval_point=eval_point))

    if chunk_rounds > 1:
        # one chunk function per distinct size (sizes differ only at eval
        # boundaries and the tail)
        multi_fns: dict = {}
        r0 = chunk_i = 0
        while r0 < num_rounds:
            # chunks END at eval boundaries, so evaluation sees the state
            # right after the eval round
            boundary = min((r0 // eval_every + 1) * eval_every, num_rounds)
            size = min(chunk_rounds, boundary - r0)
            fn = multi_fns.get(size)
            if fn is None:
                fn = multi_fns[size] = chain_rounds(strat.round, size)
            with clock.chunk(size):
                state, stacked = fn(state, train_data, seed, r0)
                fence(device)
            if chunk_i == 0:
                hist.compile_s = clock.compile_s
            for i, metrics in enumerate(unstack_metrics(
                    metrics_to_host(stacked), size)):
                consume_round(r0 + i, metrics, compile_round=chunk_i == 0)
            r0 += size
            chunk_i += 1
    else:
        for r in range(num_rounds):
            with clock.round():
                state, metrics = strat.round(state, train_data, (seed, r))
                # fence, so the clock sees the work, not its queueing
                fence(device)
            if r == 0:
                hist.compile_s = clock.compile_s
            consume_round(r, metrics, compile_round=r == 0)

    if tracer is not None:
        if graph.rounds > 0:
            tracer.write(graph.to_record())
        tracer.write(summary_record(
            rounds=num_rounds, wall_s=clock.elapsed(),
            compile_s=clock.compile_s,
            final_accuracy=hist.accuracy[-1] if hist.accuracy else None))
        tracer.close()
    return hist
