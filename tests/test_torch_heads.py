"""The port's margin heads beyond ArcFace and the memory-blended two
(sphereface, cosface, mv_softmax, curricularface, adaface, elastic_cosface,
elastic_arcface, magface, combined_margin, subcenter_arcface, adacos) against
the JAX package's: the eager [N, C] heads (pre-margin and post-margin logits,
norms, loss_g, the new state, and the gradients of CE + 0.1 loss_g), the
fused path of the nine that the JAX package fuses, the kernel initialisers
and the state bridge.

Inputs are made with numpy from a seed and handed to both packages. The
JAX fused path runs its Pallas kernels in interpret mode (block_n=16,
block_c=64), as its own tests do; the port's runs the plain versions its
wrappers compute on CPU tensors. The elastic heads' normal draw is JAX's,
handed to the port through `margins._normal_noise`. Tolerances are those of
tests/test_fused_head.py:42-84: logits and losses rtol = atol = 2e-5, states
and loss_g rtol 1e-5 atol 1e-6, gradients rtol 5e-4 atol 2e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.heads.fused_adapter import (
    FUSED_HEADS as JFUSED_HEADS)
from face_recognition_models_tpu.heads.fused_adapter import (
    fused_apply as jfused_apply)
from face_recognition_models_tpu.train.losses import (
    mean_cross_entropy as jmean_ce)
from face_recognition_models_tpu.train.metrics import topk_accuracy as jtopk
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads import available_heads, get_head
from face_recognition_models_tpu_torch.heads import margins as tmargins
from face_recognition_models_tpu_torch.heads.fused_adapter import (
    FUSED_HEADS,
    fused_apply,
    use_fused,
)
from face_recognition_models_tpu_torch.train.losses import mean_cross_entropy
from face_recognition_models_tpu_torch.train.metrics import topk_accuracy
from face_recognition_models_tpu_torch.utils.weights import (
    head_state_from_jax)

N, D, C = 24, 64, 100   # C not a multiple of block_c
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-4, atol=2e-6)

# (head, config overrides): every new head, and the second margin type or
# mode of those that have one
EAGER_CASES = [
    ("sphereface", {}), ("cosface", {}), ("mv_softmax", {}),
    ("mv_softmax", {"margin_type": "arc"}), ("curricularface", {}),
    ("adaface", {}), ("elastic_cosface", {}),
    ("elastic_cosface", {"plus": True}), ("elastic_arcface", {}),
    ("elastic_arcface", {"plus": True}), ("magface", {}),
    ("magface", {"easy_margin": True}), ("combined_margin", {}),
    ("combined_margin", {"m1": 1.2, "m2": 0.3, "m3": 0.2}),
    ("subcenter_arcface", {}), ("adacos", {}), ("adacos", {"dynamic": False}),
]
NEW_FUSED = [c for c in EAGER_CASES if c[0] in FUSED_HEADS]


def _id(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the small ops of these heads run far slower with many intra-op
    # threads under the parallel test run
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _setup(name, kw, seed=0, ignore=True):
    """(JAX cfg, port cfg, kernel, feats, labels, JAX state, JAX rng) with
    the kernel from the JAX initialiser; a -1 label in row 3 unless
    `ignore` is False."""
    jc = jcfg.make_head_config(name, feature_dim=D, num_classes=C, **kw)
    tc = tcfg.make_head_config(name, feature_dim=D, num_classes=C, **kw)
    jhead = jget_head(name)
    k_kernel, k_head = jax.random.split(jax.random.PRNGKey(seed))
    kernel = np.asarray(jhead.init_kernel(k_kernel, jc))
    rs = np.random.RandomState(seed)
    feats = (10.0 * rs.randn(N, D)).astype(np.float32)
    labels = rs.randint(0, C, N).astype(np.int32)
    if ignore:
        labels[3] = -1
    return jc, tc, kernel, feats, labels, jhead.init_state(jc), k_head


@pytest.fixture()
def jax_noise(monkeypatch):
    """Route the port's elastic-margin draw to JAX's draw for `key`:
    returns a setter taking the JAX key of the next call."""
    keys = []

    def noise(rng, n, device):
        return torch.from_numpy(np.array(
            jax.random.normal(keys[-1], (n,), jnp.float32))).to(device)

    monkeypatch.setattr(tmargins, "_normal_noise", noise)
    return keys.append


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               err_msg=what, **tol)


def _close_state(got, want):
    if want is None:
        assert got is None
        return
    want = head_state_from_jax_tree(want)
    assert type(got)._fields == tuple(want)
    for field, x in zip(got._fields, got):
        w = want[field]
        assert x.numpy().dtype == w.dtype, field
        _close(x.detach().numpy(), w, STATE_TOL, field)


def head_state_from_jax_tree(state):
    """{field: numpy leaf} of a JAX head state (a flax struct)."""
    return {f: np.asarray(getattr(state, f))
            for f in state.__dataclass_fields__}


def test_registry_matches_jax():
    from face_recognition_models_tpu.heads.base import (
        available_heads as javailable)
    assert available_heads() == javailable()
    assert len(available_heads()) == 14
    assert set(FUSED_HEADS) == set(JFUSED_HEADS)
    assert sorted(tcfg.HEAD_CONFIGS) == sorted(jcfg.HEAD_CONFIGS)
    for name in available_heads():
        assert get_head(name).requires_rng == jget_head(name).requires_rng
        assert (get_head(name).requires_minput
                == jget_head(name).requires_minput)


@pytest.mark.parametrize("name", sorted(jcfg.HEAD_CONFIGS))
def test_head_config_defaults_match_jax(name):
    want = jcfg.make_head_config(name)
    got = tcfg.make_head_config(name)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
        f: getattr(want, f) for f in want.__dataclass_fields__}


def test_parse_head_overrides_types():
    got = tcfg.parse_head_overrides(
        "mv_softmax", ["margin_type=arc", "mv_weight=1.2"])
    assert got == {"margin_type": "arc", "mv_weight": 1.2}
    assert tcfg.parse_head_overrides("subcenter_arcface", ["k=2"]) == {"k": 2}
    assert tcfg.parse_head_overrides("elastic_arcface", ["plus=true"]) == {
        "plus": True}
    with pytest.raises(ValueError, match="expected key=value"):
        tcfg.parse_head_overrides("sphereface", ["s=64"])


def test_use_fused_rule():
    for name in available_heads():
        assert use_fused(name, "auto") == (name in JFUSED_HEADS)
        assert use_fused(name, "eager") is False
    assert use_fused("cosface", "fused") is True
    for name in ("subcenter_arcface", "adacos"):
        with pytest.raises(ValueError, match=name):
            use_fused(name, "fused")
    with pytest.raises(ValueError, match="head_path"):
        use_fused("arcface", "jnp")


@pytest.mark.parametrize("case", EAGER_CASES, ids=_id)
def test_eager_head_matches_jax(case, jax_noise):
    """Forward (pre-logits, logits, norms, loss_g, state, the one-hot) and
    the gradients of CE + 0.1 loss_g to feats and kernel."""
    name, kw = case
    jc, tc, kernel, feats, labels, jstate, rng = _setup(name, kw)
    jhead, head = jget_head(name), get_head(name)
    jlab = jnp.asarray(labels)

    def jloss(k, f):
        out = jhead.apply(jc, k, f, jlab, jstate, rng=rng)
        return jmean_ce(out.logits, jlab) + 0.1 * out.loss_g, out

    (_, jout), (jgk, jgf) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(kernel), jnp.asarray(feats))

    tk = torch.tensor(kernel, requires_grad=True)
    tf = torch.tensor(feats, requires_grad=True)
    tstate = head_state_from_jax(name, _host(jstate))
    jax_noise(rng)
    out = head.apply(tc, tk, tf, torch.tensor(labels), tstate,
                     rng=torch.Generator())
    loss = mean_cross_entropy(out.logits, torch.tensor(labels)) \
        + 0.1 * out.loss_g
    loss.backward()

    _close(out.pre_logits.detach(), jout.pre_logits, LOGIT_TOL, "pre_logits")
    _close(out.logits.detach(), jout.logits, LOGIT_TOL, "logits")
    _close(out.norms.detach(), jout.norms, LOGIT_TOL, "norms")
    _close(out.loss_g.detach(), jout.loss_g, STATE_TOL, "loss_g")
    assert np.array_equal(out.one_hot.numpy(), np.asarray(jout.one_hot))
    assert not out.one_hot[3].any()    # the ignore label: no target column
    _close_state(out.state, jout.state)
    _close(tk.grad, jgk, GRAD_TOL, "d kernel")
    _close(tf.grad, jgf, GRAD_TOL, "d feats")
    acc = topk_accuracy(out.pre_logits.detach(), torch.tensor(labels))
    jacc = jtopk(jout.pre_logits, jlab)
    assert [float(a) for a in acc] == [float(a) for a in jacc]


def test_sphereface_annealing_over_steps():
    """The int32 iter and the annealed lambda over 4 chained steps (and the
    state the first step starts from)."""
    jc, tc, kernel, _, _, jstate, _ = _setup("sphereface", {})
    tstate = head_state_from_jax("sphereface", _host(jstate))
    assert tstate.iter.dtype == torch.int32 and int(tstate.iter) == 0
    init = get_head("sphereface").init_state(tc)
    assert init.iter.dtype == torch.int32 and int(init.iter) == 0
    rs = np.random.RandomState(5)
    for step in range(4):
        feats = (10.0 * rs.randn(N, D)).astype(np.float32)
        labels = rs.randint(0, C, N).astype(np.int32)
        jout = jget_head("sphereface").apply(jc, jnp.asarray(kernel),
                                             jnp.asarray(feats),
                                             jnp.asarray(labels), jstate)
        out = get_head("sphereface").apply(tc, torch.tensor(kernel),
                                           torch.tensor(feats),
                                           torch.tensor(labels), tstate)
        _close(out.logits, jout.logits, LOGIT_TOL, f"logits step {step}")
        jstate, tstate = jout.state, out.state
        assert int(tstate.iter) == int(jstate.iter) == step + 1
        assert tstate.iter.dtype == torch.int32


@pytest.mark.parametrize("case", NEW_FUSED, ids=_id)
def test_fused_head_matches_jax_fused(case, jax_noise):
    """The port's fused_apply (plain kernel versions) against JAX's
    fused_apply(interpret=True): loss, loss_g, top-k, norms, state, and the
    gradients of loss_id + 0.1 loss_g to feats and kernel."""
    name, kw = case
    jc, tc, kernel, feats, labels, jstate, rng = _setup(name, kw,
                                                        ignore=False)
    jlab = jnp.asarray(labels)

    def jloss(k, f):
        out = jfused_apply(jc, k, f, jlab, jstate, rng=rng, block_n=16,
                           block_c=64, interpret=True)
        return out.loss_id + 0.1 * out.loss_g, out

    (_, jout), (jgk, jgf) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(kernel), jnp.asarray(feats))

    tk = torch.tensor(kernel, requires_grad=True)
    tf = torch.tensor(feats, requires_grad=True)
    jax_noise(rng)
    out = fused_apply(tc, tk, tf, torch.tensor(labels),
                      head_state_from_jax(name, _host(jstate)),
                      rng=torch.Generator())
    (out.loss_id + 0.1 * out.loss_g).backward()

    _close(out.loss_id.detach(), jout.loss_id, LOGIT_TOL, "loss_id")
    _close(out.loss_g.detach(), jout.loss_g, STATE_TOL, "loss_g")
    _close(out.norms.detach(), jout.norms, LOGIT_TOL, "norms")
    assert float(out.acc1) == float(jout.acc1)
    assert float(out.acc5) == float(jout.acc5)
    _close_state(out.state, jout.state)
    _close(tk.grad, jgk, GRAD_TOL, "d kernel")
    _close(tf.grad, jgf, GRAD_TOL, "d feats")


@pytest.mark.parametrize("case", NEW_FUSED, ids=_id)
def test_fused_head_matches_own_eager_head(case):
    """The port's two paths on the same inputs and the same generator seed:
    loss (CE + loss_g), top-k and the new state."""
    name, kw = case
    _, tc, kernel, feats, labels, jstate, _ = _setup(name, kw, seed=2,
                                                     ignore=False)
    state = head_state_from_jax(name, _host(jstate))
    kernel, feats, labels = map(torch.tensor, (kernel, feats, labels))
    out = get_head(name).apply(tc, kernel, feats, labels, state,
                               rng=torch.Generator().manual_seed(9))
    fused = fused_apply(tc, kernel, feats, labels, state,
                        rng=torch.Generator().manual_seed(9))
    want = mean_cross_entropy(out.logits, labels) + out.loss_g
    _close(fused.loss_id + fused.loss_g, want, LOGIT_TOL, "loss")
    acc1, acc5 = topk_accuracy(out.pre_logits, labels)
    assert (float(fused.acc1), float(fused.acc5)) == (float(acc1),
                                                      float(acc5))
    _close(fused.norms, out.norms, LOGIT_TOL, "norms")
    if out.state is not None:
        for field, a, b in zip(out.state._fields, fused.state, out.state):
            _close(a, b, STATE_TOL, field)


def test_elastic_heads_need_a_generator():
    _, tc, kernel, feats, labels, _, _ = _setup("elastic_arcface", {})
    with pytest.raises(ValueError, match="Generator"):
        get_head("elastic_arcface").apply(tc, torch.tensor(kernel),
                                          torch.tensor(feats),
                                          torch.tensor(labels), None)


def test_elastic_margin_draws_from_the_generator():
    """Same seed, same margins; the plus mode lays the sorted margins out
    by the stable rank of the target cosine, ties in index order."""
    t_cos = torch.tensor([0.5, 0.2, 0.5, 0.9, 0.2])
    valid = torch.tensor([True, True, True, True, False])
    a = tmargins._elastic_margin(torch.Generator().manual_seed(1), t_cos,
                                 valid, 0.5, 0.1, False)
    b = tmargins._elastic_margin(torch.Generator().manual_seed(1), t_cos,
                                 valid, 0.5, 0.1, False)
    assert torch.equal(a, b) and a[4] == 0.0
    assert bool(((a[:4] >= 0.4) & (a[:4] <= 0.6)).all())
    noise = torch.randn(5, generator=torch.Generator().manual_seed(1))
    plus = tmargins._elastic_margin(torch.Generator().manual_seed(1), t_cos,
                                    valid, 0.5, 0.1, True)
    want = np.sort(np.clip(0.5 + 0.1 * noise.numpy(), 0.4, 0.6))[
        np.argsort(-t_cos.numpy(), kind="stable")]
    want[4] = 0.0
    np.testing.assert_array_equal(plus.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("name", ["cosface", "curricularface",
                                  "subcenter_arcface", "sphereface"])
def test_kernel_initialisers(name):
    """Each head's init: the JAX initialiser's shape and law (unit columns;
    normal(0.01); xavier over D + C k), repeatable from the generator."""
    tc = tcfg.make_head_config(name, feature_dim=D, num_classes=C)
    init = get_head(name).init_kernel
    w = init(tc, torch.Generator().manual_seed(3))
    assert torch.equal(w, init(tc, torch.Generator().manual_seed(3)))
    k = getattr(tc, "k", 1)
    assert w.shape == (D, C * k) and w.dtype == torch.float32
    jw = np.asarray(jget_head(name).init_kernel(
        jax.random.PRNGKey(0), jcfg.make_head_config(
            name, feature_dim=D, num_classes=C)))
    assert jw.shape == tuple(w.shape)
    if name == "cosface":
        np.testing.assert_allclose(w.norm(dim=0).numpy(), 1.0, rtol=1e-6)
    elif name == "curricularface":
        assert abs(float(w.std()) - 0.01) < 5e-4
        assert abs(float(w.std()) - float(jw.std())) < 5e-4
    else:
        bound = np.sqrt(6.0 / (D + C * k))
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.95 * bound
        assert float(np.abs(jw).max()) <= bound


@pytest.mark.parametrize("name", ["sphereface", "curricularface", "adaface",
                                  "adacos"])
def test_head_state_from_jax_new_states(name):
    jc = jcfg.make_head_config(name, feature_dim=D, num_classes=C)
    jstate = jget_head(name).init_state(jc)
    got = head_state_from_jax(name, _host(jstate))
    want = get_head(name).init_state(
        tcfg.make_head_config(name, feature_dim=D, num_classes=C))
    assert type(got) is type(want)
    for field, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=field)
