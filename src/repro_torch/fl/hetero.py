"""Device heterogeneity and semi-asynchronous rounds — reference
`repro.fl.hetero`.

1. **Device vectors.** `sample_device_vectors` turns a
   `configs.base.DeviceProfile` into per-client speed, channel-rate and
   energy vectors (families uniform, bimodal, zipf), drawn with numpy
   from `profile.seed` exactly as the reference draws them. They set each
   client's round wall-time (`local_wall_times`) and, through
   `comms.linkcost.scale_by_channel_rate`, the Eq. 9 cost matrix.

2. **Versioned peer store.** `PeerStore` is a ring of V published
   snapshots with leaves (V, M, ...). A peer that is stale (a channel
   event lag, or blocked by the deadline) serves its last published
   version instead of losing its candidate column
   (`CommsConfig.stale_mode="serve"`). This round's participants exchange
   in real time, so their columns are their live parameters; only absent
   peers are served from the store. With lag 0 the gather returns the
   stored tensors bit for bit.

   Unlike the reference's functional store, `store_publish` writes slot
   `rnd % V` in place, as a KV cache is written: at paper scale the
   store holds V·M copies of the extractor and header (1.43 GB at V=4,
   M=16, bf16), and a rebuilt ring would double that. So a round
   CONSUMES its input state's store: after `round(state, ...)` returns,
   the old `state.store` holds the new ring. Rebind the returned state,
   and never run a round twice from the same state.

3. **Deadline gate.** `stage_deadline_gate` is an engine stage any
   strategy can put first. A client's round wall-time is
   `n_steps·step_time/speed + comm/rate`; under a finite deadline T it
   completes one local update every `ceil(wall/T)` rounds (staggered
   offsets) and is left out of the exchange in between. Peers keep
   pulling its last published version, discounted by `(1 + lag)^(−α)`
   (`core.aggregation.staleness_weights`). With `deadline_s=inf` and a
   uniform profile every gate, weight and serve operation is an identity
   and `pfeddst_async` reproduces `pfeddst` bit for bit.

The round counter is a host int in the port (`PopulationState.round`
lives on the CPU), so the gate computes its completer vector on the host
from the static schedule and moves one (M,) bool to the device: no
device→host sync is added to a round. Negative ring positions (round 0
serves slot `−1 mod V = V − 1`) use Python's / torch's floor modulo,
never `torch.fmod`.

Simulation model (the reference's approximation): a straggler's update
is computed on the round it completes, from the state it holds then; the
pulls it would have made mid-flight are not replayed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import DeviceProfile
from repro_torch.utils.pytree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# device vectors — per-client capability sampled from a DeviceProfile
# ---------------------------------------------------------------------------


class DeviceVectors(NamedTuple):
    """Per-client capability vectors, all (M,) float32 numpy.

    speed         relative compute speed (1.0 = reference device)
    channel_rate  relative link rate (scales the fabric's links and the
                  Eq. 9 `c` matrix through `scale_by_channel_rate`)
    energy_scale  relative energy per unit work (slow devices burn more)
    """
    speed: np.ndarray
    channel_rate: np.ndarray
    energy_scale: np.ndarray


def sample_device_vectors(profile: DeviceProfile, m: int) -> DeviceVectors:
    """The (M,) device vectors a `DeviceProfile` names; deterministic in
    `profile.seed` (numpy `default_rng`, the reference's draws). A
    uniform profile gives exact ones."""
    rng = np.random.default_rng(profile.seed)
    if profile.family == "uniform":
        speed = np.ones(m)
    elif profile.family == "bimodal":
        n_slow = int(round(m * profile.straggler_fraction))
        speed = np.ones(m)
        slow = rng.permutation(m)[:n_slow]
        speed[slow] = 1.0 / max(profile.straggler_slowdown, 1.0)
    elif profile.family == "zipf":
        ranks = rng.permutation(m).astype(np.float64)
        speed = (1.0 + ranks) ** (-profile.zipf_exponent)
    else:
        raise KeyError(
            f"unknown device-profile family {profile.family!r}; "
            "available: uniform | bimodal | zipf")
    rate = speed.copy() if profile.rate_follows_speed else np.ones(m)
    return DeviceVectors(speed=speed.astype(np.float32),
                         channel_rate=rate.astype(np.float32),
                         energy_scale=(1.0 / speed).astype(np.float32))


def local_wall_times(devices: DeviceVectors, n_steps: int,
                     profile: DeviceProfile) -> np.ndarray:
    """(M,) seconds of simulated device time for one round's local work:
    `n_steps` steps at the client's speed plus one payload exchange at
    its channel rate."""
    compute = n_steps * profile.step_time_s / devices.speed
    comm = profile.comm_s / devices.channel_rate
    return (compute + comm).astype(np.float32)


# ---------------------------------------------------------------------------
# versioned peer store — the (V, M, ...) ring of published snapshots
# ---------------------------------------------------------------------------

class PeerStore(NamedTuple):
    """Ring of published parameter versions.

    params     dict tree whose leaves carry leading (V, M, ...) axes; slot
               `r % V` holds, after round r's publish, the latest
               published version of EVERY client (non-publishers are
               carried forward, so the freshest version never falls off
               the ring). Written in place by `store_publish`.
    pub_round  (V, M) int32 — the round each slot's snapshot was
               published at (ages the served version).
    lag        (M,) int32 — deadline misses since the client's last
               publish: the staleness the aggregation weights discount
               (plus any channel event lag), excluding sampling-induced
               age, which the synchronous protocol does not penalise.
    """
    params: Any
    pub_round: Any
    lag: Any


def store_depth(store: PeerStore) -> int:
    return int(store.pub_round.shape[0])


def init_peer_store(tree, depth: int) -> PeerStore:
    """All V slots hold `tree` (the initial parameters), published at
    round 0. The slots are real copies: `store_publish` writes them."""
    depth = max(int(depth), 1)
    first = tree_leaves(tree)[0]
    m = first.shape[0]
    return PeerStore(
        params=tree_map(lambda x: x.unsqueeze(0).repeat(
            (depth,) + (1,) * x.dim()), tree),
        pub_round=torch.zeros((depth, m), dtype=torch.int32,
                              device=first.device),
        lag=torch.zeros(m, dtype=torch.int32, device=first.device))


def _gather_slot(leaf, idx):
    """leaf (V, M, ...), idx (M,) → (M, ...): client j's entry of slot
    idx[j]. A pure integer gather (no arithmetic), so a lag-0 serve
    returns the stored tensor bit for bit."""
    cols = torch.arange(leaf.shape[1], device=leaf.device)
    return leaf[idx, cols]


def store_serve(store: PeerStore, rnd: int, event_lag=None):
    """The version each peer serves at round `rnd` → (served tree, age).

    Serving precedes round `rnd`'s training, so the freshest slot is
    `(rnd − 1) % V`; a peer with channel lag l serves slot
    `(rnd − 1 − l) % V` (l clipped to V − 1). `age[j] = rnd − pub_round`
    of the slot served."""
    v = store_depth(store)
    device = store.pub_round.device
    m = store.pub_round.shape[1]
    if event_lag is None:
        lag = torch.zeros(m, dtype=torch.int64, device=device)
    else:
        lag = event_lag.to(device).clamp(0, v - 1).long()
    idx = torch.remainder(int(rnd) - 1 - lag, v)
    served = tree_map(lambda x: _gather_slot(x, idx), store.params)
    age = int(rnd) - _gather_slot(store.pub_round, idx)
    return served, age


def store_publish(store: PeerStore, tree, fresh, blocked,
                  rnd: int) -> PeerStore:
    """End-of-round publish into slot `rnd % V`, in place (see the module
    docstring: the input store is consumed).

    fresh    (M,) bool — clients that completed a local update this
             round: their snapshot is `tree`'s row, pub_round is `rnd`,
             their miss counter resets.
    blocked  (M,) bool — clients gated out by the deadline: their latest
             version carries forward and their miss counter increments.
             Everyone else carries forward unchanged."""
    v = store_depth(store)
    head, prev = int(rnd) % v, (int(rnd) - 1) % v

    def pub(slots, new):
        sel = fresh.reshape((-1,) + (1,) * (new.dim() - 1))
        slots[head] = torch.where(sel, new, slots[prev])
        return slots

    tree_map(pub, store.params, tree)
    store.pub_round[head] = torch.where(
        fresh, int(rnd), store.pub_round[prev]).to(torch.int32)
    lag = torch.where(fresh, 0, torch.where(blocked, store.lag + 1,
                                            store.lag)).to(torch.int32)
    return PeerStore(params=store.params, pub_round=store.pub_round, lag=lag)


# ---------------------------------------------------------------------------
# the semi-async runtime — everything the stages close over
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeteroRuntime:
    """Static view of the heterogeneity scenario: the device vectors,
    each client's round wall-time, the deadline, the staleness exponent
    and the ring depth. `profiled` is False when no DeviceProfile was
    configured: the gate then emits no wall-time metrics, so an
    un-profiled pfeddst_async run reports the zero device wall-clock a
    synchronous strategy does."""
    devices: DeviceVectors
    wall_s: np.ndarray          # (M,) per-client round wall-time
    deadline_s: float           # inf → synchronous (no gating)
    alpha: float                # (1 + lag)^(−alpha) aggregation discount
    depth: int                  # peer-store ring depth V
    profiled: bool = True


def make_hetero_runtime(fl, m: int, n_steps: int) -> HeteroRuntime:
    """The runtime of `fl` (profile defaults to uniform; a deadline of
    None or ≤ 0 is infinite)."""
    profile = fl.device_profile or DeviceProfile()
    devices = sample_device_vectors(profile, m)
    deadline = fl.deadline_s
    if deadline is None or deadline <= 0:
        deadline = float("inf")
    return HeteroRuntime(devices=devices,
                         wall_s=local_wall_times(devices, n_steps, profile),
                         deadline_s=float(deadline),
                         alpha=float(fl.staleness_alpha),
                         depth=max(int(fl.version_depth), 1),
                         profiled=fl.device_profile is not None)


def completion_schedule(runtime: HeteroRuntime):
    """Static (periods, offsets) int32 arrays of the deadline schedule: a
    client of wall-time w completes one update every `ceil(w / deadline)`
    rounds, first at round `i % period`; an infinite deadline gives
    period 1 for everyone."""
    wall = np.asarray(runtime.wall_s, np.float64)
    m = wall.shape[0]
    if np.isfinite(runtime.deadline_s):
        periods = np.maximum(np.ceil(wall / runtime.deadline_s),
                             1.0).astype(np.int32)
    else:
        periods = np.ones(m, np.int32)
    offsets = (np.arange(m) % periods).astype(np.int32)
    return periods, offsets


def completers(periods, offsets, rnd: int) -> np.ndarray:
    """(M,) bool, on the host: the clients that complete an update at
    round `rnd` (numpy's floor modulo, as `jnp.mod`)."""
    return np.mod(int(rnd) - offsets, periods) == 0


def stage_deadline_gate(runtime: HeteroRuntime, get_round):
    """Engine stage: refine `ctx.active` to the clients that meet this
    round's deadline and record the round's simulated wall-time. Put it
    first in any strategy's stages; `get_round` maps the state to its
    round counter (`lambda s: s.round`, `lambda s: s["round"]`).

      ctx.active                  &= this round's completers
      ctx.aux["deadline_blocked"] sampled ∧ online clients gated out
      ctx.devices                 the DeviceVectors
      ctx.metrics["straggler_wall_s"]  the slowest sampled client's
                                  wall-time (what a synchronous round
                                  stalls on)
      ctx.metrics["round_wall_s"] min(deadline, straggler wall)
    The two wall metrics only when `runtime.profiled`. An infinite
    deadline makes every client a completer: `active & True`."""
    periods, offsets = completion_schedule(runtime)
    wall = torch.from_numpy(np.asarray(runtime.wall_s, np.float32))
    on_device: dict = {}
    deadline = runtime.deadline_s

    def deadline_gate(state, ctx):
        device = ctx.active.device
        done = torch.from_numpy(completers(periods, offsets,
                                           int(get_round(state))))
        done = done.to(device)
        pre = ctx.active
        ctx.aux["deadline_blocked"] = pre & ~done
        ctx.active = pre & done
        ctx.devices = runtime.devices
        if runtime.profiled:
            w = on_device.get(device)
            if w is None:
                w = on_device[device] = wall.to(device)
            straggler = torch.where(pre, w, 0.0).max()
            ctx.metrics["straggler_wall_s"] = straggler
            ctx.metrics["round_wall_s"] = (
                straggler.clamp(max=deadline) if np.isfinite(deadline)
                else straggler)
        return state

    deadline_gate.stage_name = "deadline_gate"
    return deadline_gate


def pull_staleness(store: PeerStore, ctx_stale, depth: int, active=None):
    """(M,) int32 staleness of the version each peer column serves: the
    deadline misses plus this round's channel event lag (clipped to the
    ring depth). A participant (`active`) exchanges in real time, so its
    column carries no channel lag, but its misses still count: the state
    it serves has not trained since."""
    if ctx_stale is None:
        event = torch.zeros_like(store.lag)
    else:
        event = ctx_stale.to(store.lag.device).clamp(0, depth - 1).to(
            torch.int32)
    if active is not None:
        event = torch.where(active, 0, event)
    return (store.lag + event).to(torch.int32)
