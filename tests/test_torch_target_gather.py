"""The heads' target-column gather, `heads.base.take_columns`: the values of
`index_select` and a backward that adds repeated labels in one fixed order
(on the card index_put_ with accumulate, which sorts the indices stably;
on the CPU index_add_, serial in batch order), so that a train step with
repeated labels is bitwise repeatable on the card, where index_select's
backward adds them with float atomics.

- forward bitwise equal to index_select;
- gradient equal to JAX's `jnp.take` gradient on the same inputs with
  repeated labels (rtol 1e-6: the same few fp32 terms, summed in order),
  through the CPU's path and through the card's sorted accumulate
  (`sorted_column_sums`, run here on one thread);
- no gradient-carrying index_select left in the fused ArcFace, VPL-ArcFace
  and QAFace paths, nor in the eager QAFace head.

The card check (two default-mode train runs bitwise equal) is
`test_train_steps_repeat_bitwise` in tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.heads.base import (
    sorted_column_sums,
    take_columns,
)
from face_recognition_models_tpu_torch.heads.fused_adapter import fused_apply

D, C, N = 16, 10, 24


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(D, C).astype(np.float32)
    # every class about 2.4 times: labels repeat within the batch
    labels = rs.randint(0, C, N).astype(np.int32)
    g = rs.randn(D, N).astype(np.float32)
    return w, labels, g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_is_index_select_bitwise(seed):
    w, labels, _ = _inputs(seed)
    got = take_columns(torch.from_numpy(w), torch.from_numpy(labels))
    want = torch.from_numpy(w).index_select(1, torch.from_numpy(labels).long())
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_matches_jax_take(seed):
    w, labels, g = _inputs(seed)
    assert len(np.unique(labels)) < len(labels)
    tw = torch.from_numpy(w).requires_grad_()
    (take_columns(tw, torch.from_numpy(labels)) * torch.from_numpy(g)).sum(
        ).backward()
    want = jax.grad(lambda x: (jnp.take(x, labels, axis=1) * g).sum())(
        jnp.asarray(w))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    # columns no label picks get exactly zero
    unused = np.setdiff1d(np.arange(C), labels)
    assert not tw.grad[:, unused].any()
    before = torch.get_num_threads()
    torch.set_num_threads(1)   # the CPU's index_put_ adds across threads
    try:
        sums = sorted_column_sums(torch.from_numpy(g),
                                  torch.from_numpy(labels).long(), C)
    finally:
        torch.set_num_threads(before)
    np.testing.assert_allclose(sums.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def _graph_nodes(tensor):
    seen, stack, names = set(), [tensor.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(fn for fn, _ in node.next_functions)
    return names


@pytest.mark.parametrize("name,fused", [("arcface", True),
                                        ("vpl_arcface", True),
                                        ("qaface", True), ("qaface", False)])
def test_no_index_select_backward_in_the_heads(name, fused):
    w, labels, _ = _inputs()
    cfg = cfg_lib.make_head_config(name, feature_dim=D, num_classes=C)
    head = get_head(name)
    gen = torch.Generator().manual_seed(0)
    kernel = torch.nn.Parameter(torch.from_numpy(w))
    feats = torch.randn(N, D, generator=gen, requires_grad=True)
    minput = torch.randn(N, D, generator=gen) if name == "qaface" else None
    state = head.init_state(cfg, "cpu")
    labels = torch.from_numpy(labels)
    if fused:
        loss = fused_apply(cfg, kernel, feats, labels, state,
                           minput=minput).loss_id
    else:
        out = head.apply(cfg, kernel, feats, labels, state, minput=minput)
        loss = out.logits.sum()
    names = _graph_nodes(loss)
    assert "IndexSelectBackward0" not in names
    assert "_TakeColumnsBackward" in names
