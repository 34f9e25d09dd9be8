"""A serving artifact takes any batch: `load_embedder`'s `fn` runs a batch
larger than the program's maximum (the header's `max_batch`) in slices of
at most that many rows and joins them, as the JAX artifact, whose batch is
symbolic without a bound, takes any batch. Exported with a maximum of 4,
`fn` on 11 rows equals the live eval step on the same rows (fp32, the same
CPU kernels: bit for bit), for a ResNet and for a trunk built for its
image size."""


import numpy as np
import pytest
import torch

from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.serving.export import (
    MAX_BATCH,
    export_embedder,
    load_embedder,
)
from face_recognition_models_tpu_torch.train.step import make_eval_step

IMG = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["resnet18", "iresnet18"])
def test_fn_slices_a_batch_over_the_maximum(tmp_path, name):
    model = get_backbone(name, embed_dim=16, dtype=torch.float32,
                         image_size=IMG)
    init_weights(model, torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.frte")
    header = export_embedder(model, model.state_dict(), path,
                             image_size=IMG, platforms=["cpu"], max_batch=4)
    assert header["max_batch"] == 4
    art = load_embedder(path, device="cpu")
    assert art.meta["max_batch"] == 4
    images = np.random.RandomState(1).randint(0, 256, (11, IMG, IMG, 3),
                                              np.uint8)
    want = make_eval_step(model, device="cpu")(images).numpy()
    got = art.fn(images)
    assert got.shape == (11, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(art.fn(images[:4]), want[:4])


def test_max_batch_is_checked(tmp_path):
    model = get_backbone("resnet18", embed_dim=8, dtype=torch.float32)
    for bad in (1, MAX_BATCH + 1):
        with pytest.raises(ValueError, match="max_batch"):
            export_embedder(model, model.state_dict(),
                            str(tmp_path / "x.frte"), image_size=IMG,
                            platforms=["cpu"], max_batch=bad)
