"""The port's Inception v3 / v4 (thyroid_tpu_torch/models/cnn/inception.py)
against the JAX package on the CPU in float32: the golden inception_v3
logits from JAX's PRNGKey(0) init (224²: the aux head's SAME branch); a
forward at 299², batch 1, on the same variables with the aux head's VALID
branch held against JAX's aux_fc output; one full-width Trainer step at
107², the smallest input whose aux pool is not empty, with the loss
ce + 0.4·ce(aux), on JAX's ReLU decisions and max-pool choices; the pool
branch's border in both count_include_pad modes and the v3 and v4 mixed
blocks on numpy-drawn weights; the variable trees of both and their
YAMLs."""
from functools import lru_cache
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import (flat_tree, global_rel, golden_input,
                                golden_variables, jax_module_variables,
                                jax_step, port_step, tree_shapes_equal)
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models.cnn import inception as port_inception
from thyroid_tpu_torch.models.from_jax import load_jax_variables, to_jax_variables
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.training.configs import TRAINING_CNN

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"


@lru_cache(maxsize=None)
def golden():
    return golden_variables("inception_v3")


def _port(cfg, variables):
    model = ModelRegistry.create_model(cfg)
    load_jax_variables(model, variables)
    return model.eval()


@pytest.mark.unit
def test_golden_logits():
    """The golden fixture's logits from the port on JAX's initial
    variables at 224², at tests/unit/test_golden_parity.py's tolerance."""
    rec = np.load(GOLDEN / "inception_v3.npz")
    cfg, variables = golden()
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(golden_input(224))).numpy()
    np.testing.assert_allclose(got, rec["logits"], atol=2e-3, rtol=1e-3)


@pytest.mark.unit
def test_valid_aux_branch_at_299():
    """At 299² (configs/model/cnn/inception_v3.yaml) the aux pool is 5×5 and
    aux_conv1 takes VALID. The golden variables (no parameter shape
    depends on the input size) at batch 1: the eval logits and the aux
    head on the running statistics (the port's `aux`, fed the last mixed
    block's output) against JAX's, whose eval forward computes the head
    and drops it (its aux_fc output captured), within 1e-4."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    cfg, variables = golden()
    cfg = dict(cfg, img_size=299)
    x = golden_input(299, batch=1)
    jmodel = JaxRegistry.create_model(cfg)
    want, inter = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, capture_intermediates=lambda m, _: m.name == "aux_fc"))(
            variables, jnp.asarray(x))
    want_aux = np.asarray(inter["intermediates"]["aux_fc"]["__call__"][0])
    model = _port(cfg, variables)
    seen = {}
    model.before_aux[-1].register_forward_hook(
        lambda mod, args, out: seen.__setitem__("x", out))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        assert seen["x"].shape[1:3] == (17, 17)
        aux = model.aux(seen["x"], train=False).numpy()
    scale = max(1.0, float(np.abs(want_aux).max()))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4 * scale, rtol=1e-4)
    np.testing.assert_allclose(aux, want_aux, atol=1e-4 * scale, rtol=1e-4)


# the share of the step's ReLU and max-pool decisions the port's own
# arithmetic may take the other way from JAX's
FLIP_SHARE = 1e-4


@pytest.mark.unit
def test_aux_train_step_matches_jax(tmp_path, monkeypatch):
    """One full-width Trainer step at 107² (batch 4, dropout 0, cnn.yaml)
    on the golden parameters: the training forward returns (logits, aux)
    (aux_conv1 SAME on the 1×1 pooled map) and the loss is ce(main) +
    0.4·ce(aux), as JAX's _train_step_impl takes any tuple that is not
    DeiT's. Seeded full-width Inception v3 turns its float32 gradient on
    its discrete choices: JAX's own step moves it by 6.7e-2 (global) under
    a permutation of the batch, and the port's by 1.1e-2 under a 1e-6
    relative perturbation of the input on fixed ReLU decisions, through a
    few flipped max-pool windows. So the port's step takes JAX's ReLU
    decisions and max-pool choices (at most FLIP_SHARE of them differ from
    its own) and is held at test_torch_resnet.py's limits: the loss within
    1e-4, the gradients' global difference within 1e-3 of their norm, the
    updated running statistics within 1e-4."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    cfg, variables = golden()
    cfg = dict(cfg, img_size=107, dropout_rate=0.0, dtype="f32")
    rs = np.random.RandomState(10)
    x = rs.randn(4, 107, 107, 1).astype(np.float32)
    y = (np.arange(4) % 2).astype(np.int32)
    w = np.array([1, 1, 1, 0.5], np.float32)
    decisions, pools, flips = [], [], []
    want, grads_want, stats_want = jax_step(
        JaxRegistry.create_model(cfg), variables, x, y, w,
        decisions=decisions, pools=pools)
    got, grads, stats, _ = port_step(
        cfg, dict(TRAINING_CNN, scheduler_params=dict(
            TRAINING_CNN["scheduler_params"], warmup_steps=1)),
        variables, x, y, w, monkeypatch, tmp_path, impose=decisions,
        flips=flips, impose_pools=pools)
    assert len(flips) == len(decisions) + len(pools) and len(pools) == 4
    assert sum(f for f, _ in flips) <= FLIP_SHARE * sum(n for _, n in flips)
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (got, want)
    assert global_rel(grads, grads_want) < 1e-3
    g = flat_tree(grads)
    assert g["aux_fc.kernel"].any() and g["aux_conv1.Conv_0.kernel"].any()
    stats, stats_want = flat_tree(stats), flat_tree(stats_want)
    assert set(stats) == set(stats_want)
    for k, v in stats_want.items():
        np.testing.assert_allclose(stats[k], v, atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.unit
@pytest.mark.parametrize("count_include_pad", [True, False])
def test_branch_pool_border(count_include_pad):
    """The 3×3 stride-1 SAME average pool against flax's nn.avg_pool with
    the same count_include_pad, everywhere and at the border, where the
    two modes differ (a corner divides by 9 or by 4)."""
    x = np.random.RandomState(7).randn(2, 5, 6, 3).astype(np.float32)
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                                   padding="SAME",
                                   count_include_pad=count_include_pad))
    got = port_inception.branch_pool(torch.from_numpy(x), count_include_pad).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    corner = x[:, :2, :2].sum(axis=(1, 2)) / (9 if count_include_pad else 4)
    np.testing.assert_allclose(got[:, 0, 0], corner, atol=1e-6, rtol=1e-6)


BLOCKS = [("InceptionA", (32,), 8), ("InceptionC", (16,), 8),
          ("InceptionE", (), 8), ("InceptionV4A", (), 8),
          ("InceptionV4B", (), 8), ("InceptionV4C", (), 8)]


@pytest.mark.unit
@pytest.mark.parametrize("name,args,cin", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_mixed_blocks_match_jax(name, args, cin):
    """Each mixed block with a pool branch (v3: count_include_pad True; v4:
    False) on a 5×5 map of `cin` channels, numpy-drawn bumped weights and
    running statistics from a train-mode forward: the eval output within
    1e-5, the borders included."""
    from thyroid_tpu.models.cnn import inception as jax_inception

    from tests.torch_parity import jax_train_stats

    jmod = getattr(jax_inception, name)(*args)
    x = np.random.RandomState(8).randn(2, 5, 5, cin).astype(np.float32)
    variables = jax_train_stats(jmod, jax_module_variables(jmod, jnp.asarray(x)),
                                jnp.asarray(x))
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    port = getattr(port_inception, name)(cin, *args)
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), False, torch.float32).numpy()
    assert got.shape == want.shape == (2, 5, 5, port.out)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.unit
@pytest.mark.parametrize("name", ["inception_v3", "inception_v4"])
def test_variable_tree_and_yaml(name):
    """Both from the registry: names, shapes and collections against JAX's
    init (jax.eval_shape at 107²; inception_v3's golden variables), the
    loader's round trip exact and strict; the YAML's img_size 299,
    aux_logits and dropout_rate are read; the train forward returns the
    aux head only for v3 with aux_logits; the capture forward records the
    last mixed block's output ("features")."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    model = JaxRegistry.create_model({"name": name})
    shapes = golden()[1] if name == "inception_v3" else jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 107, 107, 1)), train=False))
    model = ModelRegistry.create_model({"name": name})
    with torch.no_grad():        # distinct values, cheaper than the initialisers
        for i, t in enumerate(model.state_dict().values()):
            t.copy_(torch.arange(t.numel()).reshape(t.shape) % 7 + i)
    tree = to_jax_variables(model)
    tree_shapes_equal(tree, shapes)
    # load_jax_variables and to_jax_variables are exact inverses, and strict
    again = ModelRegistry.create_model({"name": name})
    load_jax_variables(again, tree)
    back = to_jax_variables(again)
    for col in tree:
        got, want = flat_tree(back[col]), flat_tree(tree[col])
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), col
    params = {k: v for k, v in tree["params"].items() if k != "fc"}
    with pytest.raises(KeyError, match="fc"):
        load_jax_variables(again, {**tree, "params": params})
    cfg = yaml.safe_load((ROOT / "configs" / "model" / "cnn" / f"{name}.yaml")
                         .read_text())
    built = ModelRegistry.create_model(cfg)
    assert built.dropout_rate == cfg["params"]["dropout_rate"]
    if name == "inception_v3":
        assert built.aux_logits == cfg["params"]["aux_logits"] is True
        assert cfg["img_size"] == 299
        off = ModelRegistry.create_model({"name": name, "aux_logits": False})
        assert "aux_fc" not in to_jax_variables(off)["params"]
    else:
        assert isinstance(built, port_inception.InceptionV4)
    with torch.no_grad():
        _, inter = built(torch.zeros(1, 107, 107, 1), capture=True)
    width = 2048 if name == "inception_v3" else 1536
    assert list(inter) == ["features"] and inter["features"].shape[-1] == width
