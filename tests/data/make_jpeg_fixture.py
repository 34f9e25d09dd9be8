"""Write the JPEG fixture that chip_smoke.py's decode phase and
tests/test_torch_data.py read: 8 face-sized (250 x 250, CASIA-WebFace's
size) smooth RGB images from seed 0, saved by PIL at quality 90, and PIL's
decode of them at 112 px as `pil_112.npy` (the port's `_decode_image`).

    python tests/data/make_jpeg_fixture.py

Needs PIL; the committed output is what the card's machine, which has no
PIL, compares its native decode with.
"""

import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jpeg_fixture")
COUNT, SIZE, GRID, DECODE = 8, 250, 6, 112


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from face_recognition_models_tpu_torch.data.pipeline import _decode_image

    os.makedirs(OUT, exist_ok=True)
    rs = np.random.RandomState(0)
    paths = []
    for i in range(COUNT):
        # a smooth field: a coarse random grid resampled bicubically
        coarse = rs.randint(0, 256, (GRID, GRID, 3)).astype(np.uint8)
        img = Image.fromarray(coarse).resize((SIZE, SIZE), Image.BICUBIC)
        path = os.path.join(OUT, f"{i:02d}.jpg")
        img.save(path, quality=90)
        paths.append(path)
    decoded = np.stack([_decode_image(p, DECODE) for p in paths])
    np.save(os.path.join(OUT, f"pil_{DECODE}.npy"), decoded)
    return 0


if __name__ == "__main__":
    sys.exit(main())
