"""The port's SGD, clipping by value and gradient accumulation
(thyroid_tpu_torch/training/schedules.py, train_state.py) against the JAX
package's optax chain on the CPU in float32: six updates of a small
ViT-named parameter tree (patch embedding, class token, two blocks, head:
every layer-decay group) from numpy-drawn gradients, with warmup + cosine
and layer decay 0.9, for AdamW and SGD, clipped by norm
and by value, with optax.MultiSteps at k = 2 and 3; then JAX's
TrainState.apply_gradients (step and EMA on every mini-step) against the
port's TrainState under accumulation."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_trees_close, one_torch_thread  # noqa: F401
from thyroid_tpu_torch.training import schedules as tsched
from thyroid_tpu_torch.training.train_state import TrainState

# float32 on one CPU; an Adam update moves an element by about ±lr
# whatever its gradient's size, and lr is 1e-2 here
PARAM_ATOL = 2e-6
STEPS = 6
# port names (dots) of a ViT's layer-decay groups: decay² for the
# embedding and token, decay^(L−1−i) for block i, 1 for the head; the
# weight decay's mask takes the leaves with ndim > 1
SHAPES = {"patch_embed.kernel": (16, 6), "cls_token": (1, 1, 6),
          "block_0.attn.qkv.kernel": (6, 18), "block_0.attn.qkv.bias": (18,),
          "block_1.mlp.fc1.kernel": (6, 12), "block_1.norm1.scale": (6,),
          "head.kernel": (6, 2), "head.bias": (2,)}


class Params(torch.nn.Module):
    """A module holding SHAPES' parameters under their names (for
    TrainState)."""

    def __init__(self, named):
        super().__init__()
        self.named = dict(named)
        for i, t in enumerate(self.named.values()):
            self.register_parameter(f"p{i}", torch.nn.Parameter(t.clone()))

    def named_parameters(self, *args, **kw):
        return iter(zip(self.named, self._parameters.values()))


def jax_tree(named):
    """Port-named tensors as a nested JAX-style tree."""
    out = {}
    for n, t in named.items():
        *path, leaf = n.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out



def _draw(seed: int, scale: float):
    rs = np.random.RandomState(seed)
    return {n: torch.from_numpy((rs.randn(*s) * scale).astype(np.float32))
            for n, s in SHAPES.items()}


def _np(named):
    """Port-named tensors as JAX's numpy tree."""
    return jax.tree.map(lambda t: t.detach().numpy(), jax_tree(named))


def _schedule(module, warmup_steps: int = 2):
    return module.build_schedule(base_lr=1e-2, steps_per_epoch=2, epochs=4,
                                 warmup_steps=warmup_steps, eta_min=1e-4)


# each optimizer with each clip, and MultiSteps at k = 2 and 3 around
# both optimizers and both clips (AdamW by norm at k = 1 is
# test_torch_training.py's test_optimizer_matches_optax)
CASES = [("sgd", "norm", 1), ("sgd", "value", 1), ("adamw", "value", 1),
         ("adamw", "norm", 2), ("sgd", "value", 2), ("adamw", "value", 3),
         ("sgd", "norm", 3)]


@pytest.mark.unit
@pytest.mark.parametrize("name,clip,k", CASES,
                         ids=[f"{n}-{c}-k{k}" for n, c, k in CASES])
def test_optimizer_chain_matches_optax(name, clip, k):
    """Six updates of clip (global norm 1.0, or each element to ±0.05) →
    AdamW (wd 0.05, decay masked to ndim > 1) or SGD (momentum 0.9) →
    layer decay 0.9 over 2 layers, inside MultiSteps(k) when k > 1,
    against the JAX package's build_optimizer: parameters after every
    update within PARAM_ATOL, updates only every k-th mini-step, the inner
    count advancing once per update; the schedule's warmup makes the first
    update's learning rate 0."""
    import optax

    from thyroid_tpu.training import schedules as jsched

    okw = dict(weight_decay=0.05, gradient_clip_val=1.0 if clip == "norm" else 0.05,
               gradient_clip_algorithm=clip, layer_decay=0.9, num_layers=2,
               accumulate_steps=k, name=name)
    params = _draw(0, 0.1)
    jp = _np(params)
    tx = jsched.build_optimizer(jp, _schedule(jsched), **okw)
    ostate = tx.init(jp)
    update = jax.jit(tx.update)
    port = tsched.build_optimizer(params, _schedule(tsched), **okw)
    pstate = port.init(params)
    tp = {n: p.clone() for n, p in params.items()}
    for step in range(STEPS):
        # large enough that the norm clip and the value clip both bite
        g = _draw(10 + step, 0.5)
        upd, ostate = update(_np(g), ostate, jp)
        jp = optax.apply_updates(jp, upd)
        before = {n: p.clone() for n, p in tp.items()}
        tsched.apply_updates(tp, port.update(g, pstate, tp))
        assert_trees_close(jax_tree(tp), jp, atol=PARAM_ATOL, rtol=0)
        moved = any(not torch.equal(before[n], tp[n]) for n in tp)
        # an update every k-th mini-step; the first has lr 0 (warmup)
        assert moved == ((step + 1) % k == 0 and (step + 1) // k > 1), step
    assert pstate.count == STEPS // k
    if k > 1:
        assert (pstate.mini_step, pstate.gradient_step) == \
            (int(ostate.mini_step), int(ostate.gradient_step))


@pytest.mark.unit
@pytest.mark.parametrize("k", [2, 3])
def test_train_state_accumulation_matches_jax(k):
    """JAX's TrainState.apply_gradients with MultiSteps(k) AdamW and EMA
    0.9 against the port's TrainState over six mini-steps: the step
    advances on every mini-step, and after the first update the EMA moves
    on every mini-step toward parameters that change only every k-th;
    params and EMA within PARAM_ATOL (no warmup, so the first update
    moves)."""
    from thyroid_tpu.training import schedules as jsched
    from thyroid_tpu.training.train_state import create_train_state

    okw = dict(weight_decay=0.05, gradient_clip_val=1.0, layer_decay=0.9,
               num_layers=2, accumulate_steps=k)
    params = _draw(1, 0.1)
    model = Params(params)
    jp = _np(params)
    tx = jsched.build_optimizer(jp, _schedule(jsched, 0), **okw)
    jstate = create_train_state(SimpleNamespace(apply=None), {"params": jp},
                                tx, ema=True)
    apply = jax.jit(lambda st, g: st.apply_gradients(g, ema_decay=0.9))
    pstate = TrainState(model, tsched.build_optimizer(
        dict(model.named_parameters()), _schedule(tsched, 0), **okw), ema=True)
    for step in range(STEPS):
        g = _draw(20 + step, 0.5)
        jstate = apply(jstate, _np(g))
        ema_before = {n: e.clone() for n, e in pstate.ema_params.items()}
        params_before = {n: p.clone() for n, p in pstate.params.items()}
        pstate.apply_gradients(g, ema_decay=0.9)
        assert pstate.step == int(jstate.step) == step + 1
        updated = any(not torch.equal(params_before[n], p)
                      for n, p in pstate.params.items())
        assert updated == ((step + 1) % k == 0), step
        if step >= k:
            assert any(not torch.equal(ema_before[n], e)
                       for n, e in pstate.ema_params.items()), step
        assert_trees_close(jax_tree({n: t.detach() for n, t in
                                     pstate.params.items()}), jstate.params,
                           atol=PARAM_ATOL, rtol=0)
        assert_trees_close(jax_tree(pstate.ema_params),
                           jstate.ema_params, atol=PARAM_ATOL, rtol=0)
    assert pstate.opt_state.count == pstate.opt_state.gradient_step == \
        int(jstate.opt_state.gradient_step) == STEPS // k


@pytest.mark.unit
def test_accumulated_state_round_trips(tmp_path):
    """save_state / resume_from keep MultiSteps' mini-step, update count,
    inner moments and accumulated gradients exactly."""
    from thyroid_tpu_torch.training import checkpoint as tckpt

    model = Params(_draw(2, 0.1))
    sched = tsched.build_schedule(base_lr=1e-2, steps_per_epoch=2, epochs=4)
    state = TrainState(model, tsched.build_optimizer(
        dict(model.named_parameters()), sched, accumulate_steps=3,
        name="sgd"), ema=True)
    for step in range(4):
        state.apply_gradients(_draw(30 + step, 0.5), ema_decay=0.9)
    path = tckpt.save_checkpoint(tmp_path / "s.ckpt", state, include_opt_state=True)
    other = TrainState(model, state.tx, ema=True)
    other.opt_state.load_state_dict(tckpt.load_payload(path)["opt_state"])
    a, b = state.opt_state, other.opt_state
    assert (a.mini_step, a.gradient_step, a.count) == \
        (b.mini_step, b.gradient_step, b.count) == (1, 1, 1)
    for n in SHAPES:
        assert torch.equal(a.acc[n], b.acc[n])
        assert torch.equal(a.inner.trace[n], b.inner.trace[n])
