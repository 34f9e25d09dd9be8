"""The port's ResNet conv on the CPU where oneDNN's bf16 backward of a
padded, strided 3 x 3 conv over a 1 x 1 input reads memory it never wrote
(a resnet18's layer4 at 16 px): with the heap full of NaN, the gradients
stay finite and equal the plain fp32 conv's, within bf16 rounding."""

import pytest
import torch
import torch.nn.functional as F

from face_recognition_models_tpu_torch.models.resnet import Conv2d


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dirty_heap(g):
    """Allocate and free NaN-filled buffers of many sizes, so memory that a
    kernel reads without writing holds NaN."""
    junk = [torch.full((int(n),), float("nan"))
            for n in torch.randint(1, 300_000, (30,), generator=g)]
    junk += [torch.full((int(n),), float("nan"), dtype=torch.bfloat16)
             for n in torch.randint(1, 300_000, (30,), generator=g)]
    del junk


@pytest.mark.parametrize("cin,cout,stride", [(256, 512, 2), (64, 128, 2)])
def test_bf16_grads_over_a_1x1_input_are_finite(cin, cout, stride):
    g = torch.Generator().manual_seed(0)
    conv = Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
    for _ in range(20):
        _dirty_heap(g)
        x = torch.randn(8, cin, 1, 1, generator=g).requires_grad_(True)
        with torch.no_grad():
            conv.weight.copy_(0.02 * torch.randn(conv.weight.shape,
                                                 generator=g))
        conv.weight.grad = None
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = conv(x.to(torch.bfloat16))
        y.float().square().sum().backward()
        assert torch.isfinite(conv.weight.grad).all()
        assert torch.isfinite(x.grad).all()
        # the plain fp32 conv on the bf16-rounded operands
        xr = x.detach().to(torch.bfloat16).float().requires_grad_(True)
        wr = conv.weight.detach().to(torch.bfloat16).float().requires_grad_(
            True)
        yr = F.conv2d(xr, wr, stride=stride, padding=1)
        torch.testing.assert_close(y.float(), yr, rtol=1e-2, atol=1e-2)
        yr.to(torch.bfloat16).float().square().sum().backward()
        torch.testing.assert_close(conv.weight.grad, wr.grad, rtol=2e-2,
                                   atol=2e-2)


def test_other_inputs_take_the_conv_as_it_is():
    g = torch.Generator().manual_seed(1)
    conv = Conv2d(8, 16, 3, stride=2, padding=1, bias=False)
    for shape in ((2, 8, 2, 2), (2, 8, 5, 7)):
        x = torch.randn(shape, generator=g)
        assert torch.equal(conv(x), F.conv2d(x, conv.weight, stride=2,
                                              padding=1))
    stride1 = Conv2d(8, 16, 3, stride=1, padding=1, bias=False)
    x = torch.randn(2, 8, 1, 1, generator=g)
    assert torch.equal(stride1(x), F.conv2d(x, stride1.weight, padding=1))
