"""Verification pair-list parsing. Port of
face_recognition_models_tpu/data/pairs.py.

Equivalent of the reference's LFWPairDataset / FlatPairDataset inputs
(dataset.py:258-360) and the pair loading in cross_validate_kfold
(model_utils.py:421-436): a `pair.list` file of lines `imgA imgB label`
(names without extension, images in `<root>/imgs/<name>.jpg`), and the
insightface `.bin` form. PIL is imported only where an entry must be
decoded, encoded or resized: a `.bin` of uint8 [H, W, 3] arrays at the
asked size loads without it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def load_pair_list(pairs_file: str) -> np.ndarray:
    """Parse pair.list -> int array [P, 3] of (a, b, label).

    Mirrors model_utils.py:422-436: skips blank lines and lines with fewer
    than 3 fields; fields are integers (image ids).
    """
    pairs: List[Tuple[int, int, int]] = []
    with open(pairs_file, "r") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 3:
                continue
            pairs.append((int(parts[0]), int(parts[1]), int(parts[2])))
    if not pairs:
        raise ValueError(f"No pairs parsed from {pairs_file}")
    return np.asarray(pairs, dtype=np.int64)


def pair_image_names(pairs_file: str) -> List[Tuple[str, str, int]]:
    """Parse pair.list as string names (LFWPairDataset semantics,
    dataset.py:283-299): returns [(nameA.jpg, nameB.jpg, label)], raising on
    malformed lines like the reference's assert."""
    out: List[Tuple[str, str, int]] = []
    with open(pairs_file, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 3:
                raise ValueError(
                    "There exist lines not having 3 elements")
            out.append((parts[0] + ".jpg", parts[1] + ".jpg", int(parts[2])))
    return out


def benchmark_paths(eval_root: str, benchmark: str) -> Tuple[str, str]:
    """(pair.list path, imgs dir) for one benchmark
    (evaluate_models.py:69-71 layout: <root>/<benchmark>/{pair.list,imgs})."""
    bench_dir = os.path.join(eval_root, benchmark)
    return os.path.join(bench_dir, "pair.list"), os.path.join(bench_dir, "imgs")


def bin_path(eval_root: str, benchmark: str) -> Optional[str]:
    """Path of an insightface-format `<benchmark>.bin` benchmark, if one
    exists: either `benchmark` IS a .bin path, or `<root>/<bench>.bin`."""
    if benchmark.endswith(".bin"):
        cand = (benchmark if os.path.isabs(benchmark) or not eval_root
                else os.path.join(eval_root, benchmark))
        return cand if os.path.isfile(cand) else None
    cand = os.path.join(eval_root, benchmark + ".bin")
    return cand if os.path.isfile(cand) else None


def load_bin(path: str, image_size: int = 112
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Load an insightface verification benchmark `.bin`.

    The format the real lfw/agedb_30/cfp_fp/calfw/cplfw benchmarks ship in
    (insightface ecosystem; the reference's pair.list+imgs layout is its
    unpacked form): a pickle of `(bins, issame_list)` where `bins[2i]`,
    `bins[2i+1]` are the encoded (JPEG) images of pair `i` and
    `issame_list[i]` its label. Returns `(images [2P,H,W,3] uint8,
    pairs [P,3] int64)` where pairs rows are `(2i, 2i+1, label)` —
    directly consumable by the kfold protocol. Entries that are already
    decoded uint8 arrays are accepted as-is (some repacked bins do this).
    """
    import io as _io
    import pickle

    with open(path, "rb") as f:
        bins, issame = pickle.load(f, encoding="bytes")
    if 2 * len(issame) != len(bins):
        raise ValueError(
            f"{path}: {len(bins)} images for {len(issame)} pair labels")
    images = np.empty((len(bins), image_size, image_size, 3), np.uint8)
    for i, b in enumerate(bins):
        if isinstance(b, np.ndarray) and b.dtype == np.uint8 and b.ndim == 3:
            arr = b
            if arr.shape[:2] != (image_size, image_size):
                from PIL import Image
                with Image.fromarray(arr) as im:
                    arr = np.asarray(
                        im.resize((image_size, image_size)), np.uint8)
        else:
            from PIL import Image
            with Image.open(_io.BytesIO(bytes(b))) as im:
                im = im.convert("RGB")
                if im.size != (image_size, image_size):
                    im = im.resize((image_size, image_size))
                arr = np.asarray(im, np.uint8)
        images[i] = arr
    pairs = np.stack([
        np.arange(0, len(bins), 2, dtype=np.int64),
        np.arange(1, len(bins), 2, dtype=np.int64),
        np.asarray([int(bool(s)) for s in issame], np.int64)], axis=1)
    return images, pairs


def save_bin(path: str, images: np.ndarray, issame: np.ndarray,
             quality: int = 95) -> None:
    """Write an insightface-format `.bin` (JPEG-encoded pairs + labels).

    `images` is [2P,H,W,3] uint8 with pair i at rows (2i, 2i+1). Interop/
    test utility — the eval path reads this format, it does not require it.
    """
    import io as _io
    import pickle

    from PIL import Image

    if len(images) != 2 * len(issame):
        raise ValueError("images must hold 2 rows per issame label")
    bins = []
    for arr in images:
        buf = _io.BytesIO()
        Image.fromarray(np.asarray(arr, np.uint8)).save(
            buf, format="JPEG", quality=quality)
        bins.append(buf.getvalue())
    with open(path, "wb") as f:
        pickle.dump((bins, [bool(s) for s in issame]), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
