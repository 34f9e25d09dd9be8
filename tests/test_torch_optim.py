"""The port's optimizer factory (train/optim.py) against the JAX package's
`get_optimizer` (optax 0.2.6): each of the eight rules, with and without
global-norm clipping, over 5 updates of a small parameter tree with fixed
gradients (norms from 0.3 to 40, so the clip at 3.0 cuts some updates and
passes others), the lr a 0-d tensor; the parameters and every slot (optax's
mu, nu, trace, sum_of_squares and count) held to rtol 1e-5, atol 1e-6.
Also the ids, the defaults, the errors, overrides a rule ignores, the
masked (`emit`) update, and a state_dict loaded in place. One torch thread.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from face_recognition_models_tpu.train import optim as joptim
from face_recognition_models_tpu_torch.train import optim

RULES = ("sgd", "adam", "adamw", "rmsprop", "adagrad", "nadam", "adamax",
         "lion")
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
LR = 0.01
CLIP = 3.0
SCALES = (0.1, 5.0, 0.5, 10.0, 1.0)
# what the JAX package's fit passes to the factory
FIT_OVERRIDES = {"momentum": 0.9, "weight_decay": 5e-4, "nesterov": False}
TOL = {"rtol": 1e-5, "atol": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(seed=0):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (scale * rs.randn(*s)).astype(np.float32)
              for k, s in SHAPES.items()} for scale in SCALES]
    return params, grads


def _jax_slots(opt_state):
    """{(slot, param key): array} and [counts] of an optax state."""
    slots, counts = {}, []
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(k, "name", None) for k in path]
        keys = [getattr(k, "key", None) for k in path]
        if "count" in names:
            counts.append(int(leaf))
        for slot in ("mu", "nu", "trace", "sum_of_squares"):
            if slot in names:
                slots[(slot, keys[-1])] = np.asarray(leaf)
    return slots, counts


def _run_both(name, overrides, steps=len(SCALES)):
    params, grads = _tree()
    tx = joptim.get_optimizer(name, LR, **overrides)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = optim.get_optimizer(name, list(tp.values()), LR, **overrides)
    lr = torch.tensor(LR, dtype=torch.float32)
    for g in grads[:steps]:
        updates, js = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step(lr)
    return jp, js, tp, opt


def _assert_matches(name, jp, js, tp, opt):
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   err_msg=f"param {k}", **TOL)
    slots, counts = _jax_slots(js)
    port_name = {"momentum_buffer": "trace"}
    seen = set()
    for k, p in tp.items():
        for slot, value in opt.state[p].items():
            key = (port_name.get(slot, slot), k)
            assert key in slots, f"{name}: slot {key} not in optax's state"
            np.testing.assert_allclose(value.numpy(), slots[key],
                                       err_msg=f"slot {key}", **TOL)
            seen.add(key)
    assert seen == set(slots), f"{name}: optax slots {set(slots) - seen}"
    # rmsprop and adagrad at a float lr keep no count in optax; the port's
    # sgd keeps none (its schedule reads the train state's)
    if opt.count is not None:
        assert all(int(opt.count) == c for c in counts)


@pytest.mark.parametrize("clip", [0.0, CLIP], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", RULES)
def test_rule_matches_optax(name, clip):
    jp, js, tp, opt = _run_both(name, {**FIT_OVERRIDES,
                                       "clip_grad_norm": clip})
    _assert_matches(name, jp, js, tp, opt)


@pytest.mark.parametrize("name", RULES)
def test_overrides_reach_the_rule(name):
    """b1 / b2 / decay / eps overrides reach the rules that read them, and
    nadam ignores them as the JAX factory does; keys a rule does not read
    (rmsprop's decay for adam, ...) are ignored."""
    overrides = {"b1": 0.8, "b2": 0.95, "decay": 0.9, "eps": 1e-6,
                 "weight_decay": 1e-3, "momentum": 0.5, "nesterov": True}
    jp, js, tp, opt = _run_both(name, overrides)
    _assert_matches(name, jp, js, tp, opt)


def test_ids_defaults_and_errors():
    assert optim.OPTIMIZER_DICT == joptim.OPTIMIZER_DICT
    assert optim.OPTIMIZER_CONFIGS == joptim.OPTIMIZER_CONFIGS
    p = [torch.nn.Parameter(torch.ones(3))]
    for i, name in optim.OPTIMIZER_DICT.items():
        assert optim.optimizer_name(i) == name
        assert optim.optimizer_name(name.upper()) == name
    assert isinstance(optim.get_optimizer(2, p, 0.1), optim.Adam)
    assert isinstance(optim.get_optimizer("LION", p, 0.1), optim.Lion)
    # the defaults of OPTIMIZER_CONFIGS without overrides
    assert optim.get_optimizer("sgd", p, 0.1).param_groups[0][
        "weight_decay"] == 1e-4
    assert optim.get_optimizer("adamw", p, 0.1).hp["weight_decay"] == 0.01
    for bad in (0, 9, "sgdw"):
        with pytest.raises(ValueError) as want:
            joptim.get_optimizer(bad, 0.1)
        with pytest.raises(ValueError) as got:
            optim.get_optimizer(bad, p, 0.1)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", RULES)
def test_masked_update(name):
    """update(..., emit=False) leaves the parameters, slots and count bit
    for bit as they were; emit=True equals the unmasked update."""
    params, grads = _tree()
    runs = []
    for emit in (None, torch.tensor(True), torch.tensor(False)):
        tp = [torch.nn.Parameter(torch.tensor(v)) for v in params.values()]
        opt = optim.get_optimizer(name, tp, LR, clip_grad_norm=CLIP,
                                  **FIT_OVERRIDES)
        lr = torch.tensor(LR)
        for g in grads[:2]:
            opt.step(lr)   # no gradients yet: nothing moves
            opt.update(tp, [torch.tensor(v) for v in g.values()], lr)
        before = [x.clone() for x in [*tp, *opt.tensors()]]
        opt.update(tp, [torch.tensor(v) for v in grads[2].values()], lr,
                   emit)
        runs.append(([x.clone() for x in [*tp, *opt.tensors()]], before))
    for got, want in zip(runs[1][0], runs[0][0]):
        assert torch.equal(got, want)
    for got, want in zip(*runs[2]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ("sgd", "adamw", "adagrad"))
def test_state_dict_loads_in_place(name):
    params, grads = _tree()
    tp = [torch.nn.Parameter(torch.tensor(v)) for v in params.values()]
    opt = optim.get_optimizer(name, tp, LR, **FIT_OVERRIDES)
    for g in grads[:3]:
        for p, v in zip(tp, g.values()):
            p.grad = torch.tensor(v)
        opt.step(torch.tensor(LR))
    saved = {k: v for k, v in opt.state_dict().items()}
    saved = torch.utils._pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, saved)
    fresh = [torch.nn.Parameter(torch.tensor(v)) for v in params.values()]
    other = optim.get_optimizer(name, fresh, LR, **FIT_OVERRIDES)
    addresses = [x.data_ptr() for x in other.tensors()]
    other.load_state_dict(saved)
    assert [x.data_ptr() for x in other.tensors()] == addresses
    for got, want in zip(other.tensors(), opt.tensors(), strict=True):
        assert torch.equal(got, want)
