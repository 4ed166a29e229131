"""Federated-learning engine, strategies and simulator of the port —
reference `repro.fl`.

engine     — the round engine: declarative StrategySpec, the stage
             library, `make_round` and the chunked `make_multi_round`
strategies — FedAvg / FedPer / FedBABU / DFedAvgM / DisPFL / DFedPGP /
             PFedDST (+ the random-selection ablation and the semi-async
             pfeddst_async) as specs
hetero     — device heterogeneity and semi-async rounds: DeviceProfile
             sampling, the versioned peer store, the deadline gate stage
simulator  — the population runner: round loop (per round or in chunks),
             personalized eval, History

The exports load on first use: `fl.engine` is imported by modules that
`fl.strategies` itself imports (the open world's stages), so importing
the package must not import the strategies.
"""
import importlib

_EXPORTS = {
    "STRATEGIES": "strategies",
    "Strategy": "strategies",
    "StrategySpec": "engine",
    "ExchangePlan": "engine",
    "RoundContext": "engine",
    "History": "simulator",
    "make_round": "engine",
    "run_round": "engine",
    "make_spec": "strategies",
    "make_strategy": "strategies",
    "run_experiment": "simulator",
    "evaluate_population": "simulator",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.fl' has no attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.fl.{module}"), name)
