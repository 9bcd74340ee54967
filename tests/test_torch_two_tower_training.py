"""The port's two-tower training (compile / fit) against the JAX package's,
on the CPU.

Both packages draw the same rows from one seed; the JAX model's parameters
are carried over with ``load_jax_params``. Both fit two epochs in batches of
64 with ``shuffle=False`` and ``metrics=[]`` (so the JAX model traces its
fused loss, the port's the plain versions of K1-K3). The per-epoch losses
agree within rtol 1e-5, every parameter afterwards within rtol 1e-4,
atol 1e-6 (fp32 sums in another order, compounded over 8 steps).
"""

import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import TwoTowerModel as JTwoTowerModel

import models_tpu_torch as mt
from models_tpu_torch.blocks.optimizer import Adagrad
from models_tpu_torch.data import Loader


def jax_flat_params(model):
    return {
        "/".join(str(p) for p in path): np.asarray(var[...])
        for path, var in nnx.state(model, nnx.Param).flat_state()
    }


def build_pair(name, seed, **kw):
    jds = jax_generate(name, num_rows=300, seed=seed)
    tds = mt.generate_data(name, num_rows=300, seed=seed)
    jm = JTwoTowerModel(jds.schema, **kw)
    jm.compile()
    jm.build(JLoader(jds, 64))
    tm = mt.TwoTowerModel(tds.schema, device="cpu", **kw)
    mt.load_jax_params(tm, jax_flat_params(jm))
    return jds, tds, jm, tm


CASES = {
    "e-commerce-adagrad": ("e-commerce", dict(query_tower=(16, 8)), "adagrad", True),
    "movielens-adagrad": ("movielens-25m", dict(query_tower=(16, 8), embedding_dim=8),
                          "adagrad", True),
    "e-commerce-sgd": ("e-commerce", dict(query_tower=(16, 8)), "sgd", True),
    "movielens-unfused": ("movielens-25m", dict(query_tower=(16, 8), embedding_dim=8),
                          "adagrad", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_trajectory_matches_jax(case):
    name, kw, optimizer, fused = CASES[case]
    jds, tds, jm, tm = build_pair(name, 13, **kw)
    if not fused:
        jm.contrastive_output.fused_loss = False
        tm.contrastive_output.fused_loss = False
    jm.compile(optimizer=optimizer, learning_rate=0.05, metrics=[])
    tm.compile(optimizer=optimizer, learning_rate=0.05, metrics=[])
    jh = jm.fit(jds, epochs=2, batch_size=64, shuffle=False, verbose=0)
    th = tm.fit(tds, epochs=2, batch_size=64, shuffle=False, device="cpu")
    head = f"loss/{tm.item_id_name}/ContrastiveOutput"
    assert sorted(th.history) == sorted(jh.history)
    for key in ("loss", head):
        np.testing.assert_allclose(th.history[key], jh.history[key], rtol=1e-5, err_msg=key)
    assert th.history["loss"][1] < th.history["loss"][0]
    params = dict(tm.named_parameters())
    for key, value in jax_flat_params(jm).items():
        parts = key.split("/")
        if parts[-1] == "kernel":
            parts, value = parts[:-1] + ["weight"], value.T
        np.testing.assert_allclose(params[".".join(parts)].detach().numpy(), value,
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_adagrad_follows_optax():
    """acc starts at 0.1; update = -lr * g * rsqrt(acc + g^2 + 1e-7)."""
    import optax

    p0 = np.array([1.0, -2.0, 0.5], np.float32)
    grads = [np.array([0.3, -0.1, 0.0], np.float32), np.array([-0.2, 0.4, 1.0], np.float32)]
    tx = optax.adagrad(0.05)
    state, jp = tx.init(p0), p0
    tp = torch.tensor(p0, requires_grad=True)
    opt = Adagrad([tp], lr=0.05)
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6)


def _small():
    ds = mt.generate_data("e-commerce", num_rows=96, seed=1)
    return ds, mt.TwoTowerModel(ds.schema, query_tower=(8, 4), device="cpu")


def test_compile_refuses_what_is_not_ported():
    _, model = _small()
    with pytest.raises(NotImplementedError, match="metrics=\\[\\]"):
        model.compile(optimizer="adagrad")  # metrics=None: the top-k training metrics
    with pytest.raises(NotImplementedError, match="metrics=\\[\\]"):
        model.compile(metrics=["recall_at_10"])
    with pytest.raises(NotImplementedError, match="not ported"):
        model.compile(optimizer="lamb", metrics=[])
    with pytest.raises(ValueError, match="Unknown optimizer"):
        model.compile(optimizer="nope", metrics=[])
    with pytest.raises(NotImplementedError):
        model.fit(_small()[0], batch_size=32, device="cpu")  # never compiled


def test_slots_persist_across_fits_until_compile():
    ds, model = _small()
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    model.fit(ds, epochs=1, batch_size=32, shuffle=False, device="cpu")
    opt = model._optimizer
    model.fit(ds, epochs=1, batch_size=32, shuffle=False, device="cpu")
    assert model._optimizer is opt and model._step == 6
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    assert model._optimizer is None and model._step == 0


def test_shuffled_fit_trains_and_the_trained_model_serves():
    ds, model = _small()
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    hist = model.fit(ds, epochs=2, batch_size=32, shuffle=True, device="cpu")
    assert len(hist.history["loss"]) == 2 and np.isfinite(hist.history["loss"]).all()
    out = model.to_top_k_encoder(ds, k=3, batch_size=32, device="cpu").predict(
        ds, batch_size=32, device="cpu")
    assert out["ids"].shape == (96, 3) and np.isfinite(out["scores"]).all()


def test_loader_shuffle_is_one_seeded_permutation_per_pass():
    ds = mt.generate_data("movielens-25m", num_rows=50, seed=2)
    loader = Loader(ds, 50, shuffle=True, seed=3)
    ids = ds.to_numpy_dict()["movieId"]
    for epoch in (1, 2):
        perm = np.random.default_rng(3 + epoch * 9973).permutation(50)
        x, _ = next(iter(loader))
        np.testing.assert_array_equal(x["movieId"], ids[perm])
