"""Population FL simulator — round loop + personalized evaluation,
reference `repro.fl.simulator` (a per-round loop, no trace).

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
parameter traffic is priced. The device-heterogeneity fields stay zero
(the semi-async layer is not ported).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.comms.transport import payload_bytes_per_client
from repro_torch.core.client_state import stack_trees
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.data.pipeline import as_index_tensor
from repro_torch.device import resolve_device
from repro_torch.fl.engine import named_streams
from repro_torch.fl.strategies import make_strategy
from repro_torch.models import model as model_mod
from repro_torch.models.split import merge_params, split_params
from repro_torch.optim.sgd import sgd

FT_STREAM_KEY = 1 << 20   # keys eval-time fine-tune draws apart from rounds


@torch.no_grad()
def evaluate_population(cfg, params: dict, test_x, test_y):
    """Mean + per-client personalized test accuracy. params: leading-M."""
    m = test_x.shape[0]
    accs = torch.stack([
        model_mod.accuracy(cfg, {n: t[i] for n, t in params.items()},
                           {"images": test_x[i], "labels": test_y[i]})
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
        e, h = split_params(cfg, {k: v[i] for k, v in params.items()})
        o = opt.init(h)
        for s in range(steps):
            b = idx[s, i]
            h, o, _ = phase.phase_h(e, h, o, {"images": train_x[i][b],
                                              "labels": train_y[i][b]})
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


def scalar_metrics(metrics: dict) -> dict:
    """Every 0-d entry of a round's metrics as {name: float}."""
    return {name: float(v) for name, v in metrics.items()
            if np.ndim(v) == 0}


def _fence(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_experiment(strategy_name: str, cfg, fl, data: dict, *,
                   num_rounds: int, eval_every: int = 5,
                   steps_per_epoch: int = 2, seed: int = 0,
                   verbose: bool = True, device="cuda",
                   on_round=None) -> History:
    """data: dict(train_x, train_y, test_x, test_y), leading-M stacked
    (tensors or numpy arrays; moved to `device`).

    on_round: optional `(round_index, metrics) -> None`, called after
    each round with the round's metrics dict (arrays included, e.g.
    `select_mask`), outside the round's wall clock.

    The network comes from `fl.comms` (a `CommsConfig`: topology,
    ring_hops, hier_cluster, ..., link_model, the events p_link_drop,
    availability, p_stale, and sparse=True for the packed fabric; None
    for the costless scalar path)."""
    device = resolve_device(device)
    strat = make_strategy(strategy_name, cfg, fl, steps_per_epoch,
                          device=device)
    data = {k: torch.as_tensor(v).to(device) for k, v in data.items()}
    train_data = {"images": data["train_x"], "labels": data["train_y"]}
    state = strat.init(seed)

    payload = _message_bytes(strat, cfg, fl, state)
    hist = History()
    steady_s = 0.0
    cum_bytes, cum_net_s, cum_energy = 0, 0.0, 0.0
    t_start = time.time()
    for r in range(num_rounds):
        t0 = time.perf_counter()
        state, metrics = strat.round(state, train_data, (seed, r))
        _fence(device)
        wall = time.perf_counter() - t0
        if r == 0:
            hist.compile_s = wall
        else:
            steady_s += wall
        # the accounting reads the round's edges on the host: after the
        # timed wall, never inside it
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
        for lst, value in ((hist.round_bytes, round_bytes),
                           (hist.round_net_time_s, round_net_s),
                           (hist.round_stale_lag, mean_lag),
                           (hist.round_stale_max, max_lag),
                           (hist.round_device_wall_s, 0.0),
                           (hist.round_straggler_wall_s, 0.0),
                           (hist.round_eff_lag, 0.0)):
            lst.append(value)
        for name, value in scalar_metrics(metrics).items():
            hist.extra.setdefault(name, []).append(value)
        if on_round is not None:
            on_round(r, metrics)

        if (r + 1) % eval_every == 0 or r == num_rounds - 1:
            params = strat.params_for_eval(state)
            if strat.needs_head_finetune:
                # fresh batch draws at every eval point (round in the key)
                gen = named_streams((seed, FT_STREAM_KEY, r), ("ft",))["ft"]
                params = _finetune_heads(cfg, fl, params, data["train_x"],
                                         data["train_y"], gen)
            acc, _ = evaluate_population(cfg, params, data["test_x"],
                                         data["test_y"])
            loss_keys = [k for k in metrics if "loss" in k]
            tl = float(np.mean([float(metrics[k]) for k in loss_keys])) \
                if loss_keys else float("nan")
            hist.rounds.append(r + 1)
            hist.accuracy.append(float(acc))
            hist.train_loss.append(tl)
            hist.wall_s.append(steady_s)
            hist.comm_bytes.append(cum_bytes)
            hist.net_time_s.append(cum_net_s)
            hist.energy_j.append(cum_energy)
            hist.device_time_s.append(0.0)
            if verbose:
                print(f"[{strategy_name:16s}] round {r + 1:4d} "
                      f"acc={float(acc):.4f} loss={tl:.4f} "
                      f"comm={cum_bytes / 1e6:.2f}MB net={cum_net_s:.1f}s "
                      f"({time.time() - t_start:.0f}s)", flush=True)
    return hist
