"""The system under test, `repro_torch`, as the benchmark drives it: the
only module of the benchmark that imports the program.

The entry the window drives is the round function of
`repro_torch.fl.strategies.make_strategy(strategy, cfg, fl,
steps_per_epoch)` from `strat.init(seed)`, round r keyed (seed, r) with
the benchmark's draws, its scalar metrics brought to the host after each
round, as `fl.simulator.run_experiment`'s per-round loop does. Before the
first round every parameter is overwritten with the benchmark's own
draw, so the reference starts from the same values without taking any
from the program.

`first_steps` watches the program's one-client SGD step
(`core.partial_freeze._train_step`, which every phase step calls) for
the length of one set-up round and records each sampled client's first
phase-e step: its loss and its momentum after the step. The window's
rounds run with nothing watched."""
from __future__ import annotations

import contextlib
import dataclasses

# the engine's stage names (`stage_name`) of each layer the stage timers
# read
STAGES = {"train": ("phase_e", "phase_h"),
          "score_select": ("score_select",),
          "aggregate": ("aggregate",)}


def flat(tree, prefix: str = "") -> dict:
    """{'/'-joined path: tensor} of a nested dict of tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat(v, name))
        else:
            out[name] = v
    return out


class Port:
    def __init__(self, cell: dict, model: dict, device):
        from repro_torch.configs import FLConfig, ModelConfig
        from repro_torch.fl.strategies import make_strategy
        from repro_torch.kernels import ops
        from repro_torch.obs.registry import scalar_metrics

        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        self.cfg = ModelConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in model.items() if k in fields})
        self.fl = FLConfig(**cell["fl"])
        self.cell = cell
        self.strat = make_strategy(cell["strategy"], self.cfg, self.fl,
                                   cell["steps_per_epoch"], device=device)
        self.ops = ops
        self.scalars = scalar_metrics

    # ---- state views ---------------------------------------------------
    def params(self, state) -> dict:
        """{(part, leaf): (M, ...) tensor} of the state's parameters."""
        parts = {"e": state.extractor, "h": state.header}
        return {(part, n): t for part, tree in parts.items()
                for n, t in flat(tree).items()}

    def momenta(self, state) -> dict:
        parts = {"e": state.opt_e["mu"], "h": state.opt_h["mu"]}
        return {(part, n): t for part, tree in parts.items()
                for n, t in flat(tree).items()}

    def init(self, seed: int, specs: dict, initial):
        """strat.init(seed), every parameter leaf then overwritten by
        initial(client, name)."""
        state = self.strat.init(seed)
        leaves = {n: t for (_, n), t in self.params(state).items()}
        if set(leaves) != set(specs):
            raise RuntimeError(
                f"the program's parameters {sorted(leaves)} are not the "
                f"configuration's {sorted(specs)}")
        for n, t in leaves.items():
            if tuple(t.shape[1:]) != tuple(specs[n][0]):
                raise RuntimeError(f"{n}: the program's shape "
                                   f"{tuple(t.shape[1:])} is not "
                                   f"{tuple(specs[n][0])}")
            for c in range(t.shape[0]):
                t[c].copy_(initial(c, n))
        return state

    # ---- rounds --------------------------------------------------------
    def round(self, state, data, key, draws, round_fn=None):
        """One round and its scalar metrics on the host."""
        state, metrics = (round_fn or self.strat.round)(state, data, key,
                                                        draws)
        return state, metrics, self.scalars(metrics)

    def instrumented(self):
        """A round function whose stages are fenced and timed
        (`obs.timers.instrument_stages`), and its StageTimes."""
        from repro_torch.fl.engine import make_round
        from repro_torch.obs.timers import StageTimes, instrument_stages

        times = StageTimes()
        spec = dataclasses.replace(
            self.strat.spec,
            stages=instrument_stages(self.strat.spec.stages, times))
        return make_round(spec, self.fl, self.strat.fabric), times

    @contextlib.contextmanager
    def first_steps(self, clients, extractor):
        """Within the block, record the first phase-e step of each of
        `clients` (the round's participants, in the order they train):
        yields {"loss": {client: loss}, "mom": {(client, leaf): norm}},
        filled as the steps run. extractor: the extractor's leaf names,
        which tell a phase-e step from a phase-h one."""
        import torch
        from repro_torch.core import partial_freeze

        real = partial_freeze._train_step
        queue, want = list(clients), set(extractor)
        seen = {"loss": {}, "mom": {}}

        def watched(cfg, opt, trained, frozen, opt_state, batch, **kw):
            out = real(cfg, opt, trained, frozen, opt_state, batch, **kw)
            if queue and set(flat(trained)) == want:
                c = queue.pop(0)
                seen["loss"][c] = float(out[2]["loss"])
                mu = flat(out[1]["mu"])
                norms = torch.stack([t.float().norm() for t in mu.values()])
                seen["mom"].update(
                    {(c, n): v for n, v in zip(mu, norms.tolist())})
            return out

        partial_freeze._train_step = watched
        try:
            yield seen
        finally:
            partial_freeze._train_step = real
        if queue:
            raise RuntimeError(
                f"the first phase-e step of clients {queue} was not seen: "
                f"core.partial_freeze._train_step is no longer the step")

    # ---- readings for the check ----------------------------------------
    def round_reading(self, state, metrics, scalars) -> dict:
        return {"losses": {k: v for k, v in scalars.items() if "loss" in k},
                "mask": metrics["select_mask"].bool().cpu(),
                "loss_matrix": state.loss_matrix.float().cpu()}

    def momentum_norms(self, state) -> dict:
        return {(part, c, n): float(t[c].float().norm())
                for (part, n), t in self.momenta(state).items()
                for c in range(t.shape[0])}

    def change_norms(self, state, initial) -> dict:
        return {(c, n): float((t[c].float() - initial(c, n).float()).norm())
                for (_, n), t in self.params(state).items()
                for c in range(t.shape[0])}
