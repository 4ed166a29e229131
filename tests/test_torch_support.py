"""Parity-fixture helpers shared by the tests/test_torch_* files.

They carry arrays from the JAX reference to the PyTorch port (jax →
numpy → torch) and compute a reference round's random draws — the
participants, the probe indices, the phase-e/h batch indices and the
pfeddst_random uniform plane — with the reference's own
`named_streams` / `sample_participants` / `jax.random.split` order, so a
port round can be given exactly the reference's choices through its
`draws` hook. The tests at the bottom hold the helpers to the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.rounds import PFEDDST_STREAMS
from repro.data.pipeline import sample_batch, sample_client_batches
from repro.fl.engine import named_streams, sample_participants


def to_numpy(tree):
    """A jax pytree (or PopulationState) → the same tree of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def close_to_scale(got, want, rel, what=""):
    """max |got − want| ≤ rel · max(1, max |want|), in float32 numpy;
    → the error."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)
    return err


def to_torch(a, dtype=None):
    """A jax or numpy array → a CPU torch tensor."""
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _client_batch_idx(key, n: int, batch: int, *, total: int, rows=None):
    """The (M', B) indices `repro.data.pipeline.sample_client_batches`
    draws from `key` (positional keying over `total` clients)."""
    keys = jax.random.split(key, total)
    if rows is not None:
        keys = keys[jnp.asarray(rows)]
    return np.asarray(jax.vmap(lambda k: sample_batch(k, n, batch))(keys))


def reference_draws(key, *, m: int, ratio: float, n_local: int,
                    probe_size: int, batch_size: int, n_e: int, n_h: int):
    """The reference PFedDST round's draws under round key `key`, keyed
    by the port's stream names (see repro_torch.fl.engine)."""
    keys = named_streams(key, PFEDDST_STREAMS)
    idx, _ = sample_participants(keys["act"], m, ratio)
    idx = np.asarray(idx)

    def steps(k, n_steps):
        return np.stack([
            _client_batch_idx(ks, n_local, batch_size, total=m, rows=idx)
            for ks in jax.random.split(k, n_steps)])

    return {
        "act": idx,
        "probe": _client_batch_idx(keys["probe"], n_local, probe_size,
                                   total=m),
        "e": steps(keys["e"], n_e),
        "h": steps(keys["h"], n_h),
        "rand": np.asarray(jax.random.uniform(keys["rand"], (m, m))),
    }


# ---------------------------------------------------------------------------
# the helpers against the reference
# ---------------------------------------------------------------------------

def _data(m=5, n=7):
    rng = np.random.default_rng(0)
    return {"images": rng.normal(size=(m, n, 4, 4, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, size=(m, n)).astype(np.int32)}


def test_probe_draw_reproduces_reference_batches():
    """Exact: the injected probe indices select the reference's batches."""
    from repro_torch.data.pipeline import take_client_batches

    data = _data()
    key = jax.random.PRNGKey(3)
    ref = sample_client_batches(key, {k: jnp.asarray(v)
                                      for k, v in data.items()}, 4)
    idx = _client_batch_idx(key, 7, 4, total=5)
    got = take_client_batches({k: to_torch(v) for k, v in data.items()}, idx)
    for k in data:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_subset_draw_reproduces_reference_positional_keying():
    """Exact: active-subset draws equal the reference's rows/total draws."""
    from repro_torch.data.pipeline import take_client_batches

    data = _data()
    rows = np.array([3, 0])
    key = jax.random.PRNGKey(5)
    sub = {k: jnp.asarray(v)[rows] for k, v in data.items()}
    ref = sample_client_batches(key, sub, 3, rows=jnp.asarray(rows), total=5)
    idx = _client_batch_idx(key, 7, 3, total=5, rows=rows)
    got = take_client_batches({k: to_torch(v[rows]) for k, v in data.items()},
                              idx)
    for k in data:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_reference_draws_shapes_and_participants():
    """The draws cover the stream layout with the shapes the hook takes,
    and the participants are the reference's sample."""
    key = jax.random.PRNGKey(1)
    d = reference_draws(key, m=6, ratio=0.5, n_local=9, probe_size=4,
                        batch_size=5, n_e=2, n_h=1)
    assert d["act"].shape == (3,) and d["probe"].shape == (6, 4)
    assert d["e"].shape == (2, 3, 5) and d["h"].shape == (1, 3, 5)
    assert d["rand"].shape == (6, 6)
    keys = named_streams(key, PFEDDST_STREAMS)
    idx, _ = sample_participants(keys["act"], 6, 0.5)
    np.testing.assert_array_equal(d["act"], np.asarray(idx))
