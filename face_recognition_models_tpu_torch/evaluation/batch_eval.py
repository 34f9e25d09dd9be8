"""Batch evaluation over models x benchmarks. Port of
face_recognition_models_tpu/evaluation/batch_eval.py.

Equivalent of the reference's evaluate_models.py: load each trained model's
checkpoint, run the 10-fold verification protocol on five benchmarks
(agedb_30, cfp_fp, lfw, calfw, cplfw under <root>/<bench>/{pair.list,imgs}
or as insightface `<bench>.bin` files), and write accuracy/AUC CSV tables
(plus an XLSX workbook when pandas and openpyxl are installed — the
reference writes a 2-sheet workbook, evaluate_models.py:108-115).

Every unique image is embedded once, on the card unless device='cpu'. With
a mesh each rank embeds its share of every batch (`make_embed_fn(mesh=)`),
and rank 0 writes the tables.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.checkpoint import restore_backbone
from face_recognition_models_tpu_torch.data.pairs import (
    benchmark_paths,
    bin_path,
    load_bin,
    load_pair_list,
)
from face_recognition_models_tpu_torch.evaluation.device_protocol import (
    kfold_verification_device,
)
from face_recognition_models_tpu_torch.evaluation.openset import tpr_at_far
from face_recognition_models_tpu_torch.evaluation.verification import (
    embed_unique_images,
    kfold_verification,
    pair_cosine_similarities,
    standard_kfold_verification,
)
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.backbones import to_device
from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.train.step import make_eval_step
from face_recognition_models_tpu_torch.utils.device import resolve_device


def make_embed_fn(backbone, device=None, mesh=None):
    """`embed_fn(uint8 images) -> raw fp32 embeddings` on the device (the
    port's eval step: normalise on the device, backbone in eval mode with
    its running BatchNorm statistics). With `mesh` every rank is given the
    whole batch, embeds its 1/data of the rows and gathers the rest over
    the data group: the batch must divide by the data axis."""
    step = make_eval_step(backbone, device=device)
    if mesh is None:
        return step
    n_data = mesh.data

    def embed(images):
        n = images.shape[0]
        if n % n_data:
            raise ValueError(
                f"batch {n} not divisible by mesh data axis {n_data}")
        rows = n // n_data
        part = images[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        return coll.gather_rows(step(part), mesh)

    return embed


def _load_benchmark_images(pairs: np.ndarray, imgs_dir: str,
                           image_size: int) -> Dict[int, np.ndarray]:
    from PIL import Image
    unique = sorted({int(x) for x in pairs[:, :2].ravel()})
    out = {}
    for img_id in unique:
        path = os.path.join(imgs_dir, f"{img_id}.jpg")
        with Image.open(path) as im:
            im = im.convert("RGB")
            if im.size != (image_size, image_size):
                im = im.resize((image_size, image_size))
            out[img_id] = np.asarray(im, np.uint8)
    return out


def load_benchmark(eval_root: str, benchmark: str, image_size: int = 112
                   ) -> tuple:
    """(pairs [P,3], unique image stack [U,H,W,3], id_to_row dict) for one
    benchmark in either on-disk form: the reference's
    `<root>/<bench>/{pair.list,imgs}` directory layout, or the insightface
    ecosystem's packed `<bench>.bin` (data/pairs.load_bin) — checked in
    that order so an unpacked copy wins when both exist."""
    pairs_file, imgs_dir = benchmark_paths(eval_root, benchmark)
    if os.path.isfile(pairs_file):
        pairs = load_pair_list(pairs_file)
        images_by_id = _load_benchmark_images(pairs, imgs_dir, image_size)
        ids = sorted(images_by_id)
        id_to_row = {i: r for r, i in enumerate(ids)}
        stack = np.stack([images_by_id[i] for i in ids])
        return pairs, stack, id_to_row
    packed = bin_path(eval_root, benchmark)
    if packed is None:
        raise FileNotFoundError(
            f"benchmark '{benchmark}' not found under {eval_root!r}: "
            f"neither {pairs_file} nor a .bin form exists")
    stack, pairs = load_bin(packed, image_size)
    return pairs, stack, {i: i for i in range(len(stack))}


def evaluate_model_on_benchmark(embed_fn, eval_root: str, benchmark: str,
                                image_size: int = 112,
                                batch_size: int = 256,
                                verbose: bool = True,
                                protocol: str = "host",
                                fars: Sequence[float] = (),
                                flip: bool = False,
                                device=None):
    """Returns VerificationResult, or (VerificationResult, {far: tpr})
    when `fars` is non-empty (TPR@FAR over the full pair list,
    evaluation/openset.py).

    protocol: 'host' = the reference's inverted protocol (tune Youden on
    1 fold, test on 9) in numpy; 'device' = the same as one vectorised
    computation on `device`; 'standard' = the classic LFW/insightface
    protocol (sequential folds, accuracy-maximizing grid threshold tuned
    on 9, tested on 1) for comparing with published numbers. Pair
    'standard' with flip=True to match the published convention (flip-sum
    embeddings)."""
    pairs, stack, id_to_row = load_benchmark(eval_root, benchmark,
                                             image_size)
    emb = embed_unique_images(embed_fn, stack, batch_size, flip=flip)
    sims = pair_cosine_similarities(emb, pairs, id_to_row)
    if protocol == "device":
        res = kfold_verification_device(sims, pairs[:, 2], device=device)
    elif protocol == "standard":
        res = standard_kfold_verification(sims, pairs[:, 2],
                                          verbose=verbose)
    elif protocol == "host":
        res = kfold_verification(sims, pairs[:, 2], verbose=verbose)
    else:
        raise ValueError(f"unknown protocol {protocol!r} "
                         "(host | device | standard)")
    if not fars:
        return res
    rates = {far: tpr for far, (tpr, _) in
             tpr_at_far(sims, pairs[:, 2], fars).items()}
    return res, rates


def run_batch_evaluation(checkpoint_dir: str, eval_data_path: str,
                         benchmarks: Sequence[str],
                         head: Optional[str] = None,
                         backbone: str = "resnet18",
                         batch_size: int = 256,
                         num_classes: int = cfg_lib.CASIA_NUM_CLASSES,
                         output_dir: str = "evaluation_results",
                         image_size: int = 112,
                         which: str = "final",
                         protocol: str = "host",
                         fars: Sequence[float] = (),
                         flip: bool = False,
                         embed_dim: int = 512,
                         device=None, mesh=None) -> int:
    """which: 'final' evaluates the end-of-training snapshot; 'min_loss'
    evaluates the best-by-train-loss checkpoint (the reference's
    evaluate_models.py loads <Name>_min_loss.pth). Runs on the card
    unless device='cpu' is passed. `num_classes` is accepted for the JAX
    CLI's flag set; the embedding model does not read it. With `mesh` the
    embedding passes split over its data axis (the batch rounded up to a
    multiple of it) and rank 0 prints and writes."""
    device = resolve_device(device)
    writer = coll.is_writer(mesh)
    if mesh is not None and batch_size % mesh.data:
        batch_size += mesh.data - batch_size % mesh.data
        if writer:
            print(f"[mesh] rounded eval batch to {batch_size} "
                  f"({mesh.data} ranks)")
    if head is not None:
        model_names = [head]
    else:
        if not os.path.isdir(checkpoint_dir):
            print(f"error: checkpoint dir not found: {checkpoint_dir}")
            return 1
        model_names = sorted(
            d for d in os.listdir(checkpoint_dir)
            if os.path.isdir(os.path.join(checkpoint_dir, d)))
    if not model_names:
        print(f"No model checkpoints found under {checkpoint_dir}")
        return 1

    acc_rows: List[dict] = []
    auc_rows: List[dict] = []
    for name in model_names:
        model = get_backbone(backbone, embed_dim=embed_dim,
                             image_size=image_size)
        try:
            model.load_state_dict(restore_backbone(
                os.path.join(checkpoint_dir, name), which, model_name=name))
        except Exception as e:  # missing, corrupt or another backbone's
            print(f"[skip] {name}: could not load checkpoint ({e})")
            continue
        embed_fn = make_embed_fn(to_device(model, device), device=device,
                                 mesh=mesh)
        acc_row, auc_row = {"model": name}, {"model": name}
        for bench in benchmarks:
            try:
                res = evaluate_model_on_benchmark(
                    embed_fn, eval_data_path, bench, image_size, batch_size,
                    protocol=protocol, fars=fars, flip=flip, device=device)
            except FileNotFoundError as e:
                print(f"[skip] {name} on {bench}: {e}")
                continue
            rates = {}
            if fars:
                res, rates = res
            if writer:
                print(f"{name} on {bench}: {res}")
            acc_row[bench] = res.mean_accuracy
            acc_row[f"{bench}_std"] = res.std_accuracy
            auc_row[bench] = res.mean_auc
            auc_row[f"{bench}_std"] = res.std_auc
            for far, tpr in rates.items():
                if writer:
                    print(f"  {bench} TPR@FAR={far:g}: {tpr * 100:.3f}%")
                acc_row[f"{bench}_tpr@far={far:g}"] = tpr * 100.0
        acc_rows.append(acc_row)
        auc_rows.append(auc_row)

    if writer:
        os.makedirs(output_dir, exist_ok=True)
        _write_tables(acc_rows, auc_rows, output_dir)
    return 0


def _columns(rows: List[dict]) -> List[str]:
    """Column order as pandas.DataFrame(rows) gives it: first appearance."""
    cols: List[str] = []
    for row in rows:
        cols += [k for k in row if k not in cols]
    return cols


def _write_csv(rows: List[dict], path: str) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=_columns(rows), restval="")
        writer.writeheader()
        writer.writerows(rows)


def _write_tables(acc_rows, auc_rows, output_dir: str):
    _write_csv(acc_rows, os.path.join(output_dir, "accuracy_10fold.csv"))
    _write_csv(auc_rows, os.path.join(output_dir, "auc_10fold.csv"))
    try:
        import openpyxl  # noqa: F401
        import pandas as pd
    except ImportError:
        print("pandas / openpyxl not available — wrote CSVs only")
    else:
        with pd.ExcelWriter(
                os.path.join(output_dir, "evaluation_10fold.xlsx")) as xl:
            pd.DataFrame(acc_rows).to_excel(xl, sheet_name="accuracy",
                                            index=False)
            pd.DataFrame(auc_rows).to_excel(xl, sheet_name="auc",
                                            index=False)
    print(f"Wrote evaluation tables to {output_dir}/")
