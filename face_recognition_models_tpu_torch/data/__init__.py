"""Data sources of the port: identity trees, packs, RecordIO sets and
in-memory arrays, all behind the Loader contract (`steps_per_epoch()`,
`epoch(i)` -> uint8 NHWC images, int32 labels); `PKLoader` and
`PKRecLoader` give the triplet path's P identities x K images batches."""

from face_recognition_models_tpu_torch.data.index import ImageFolderIndex
from face_recognition_models_tpu_torch.data.packed import (
    PackedDataset,
    PackedLoader,
    pack_dataset,
)
from face_recognition_models_tpu_torch.data.pairs import (
    load_pair_list,
    pair_image_names,
)
from face_recognition_models_tpu_torch.data.pipeline import (
    ArrayLoader,
    Loader,
    PKLoader,
)
from face_recognition_models_tpu_torch.data.recordio import (
    PKRecLoader,
    RecLoader,
    RecordIODataset,
)
from face_recognition_models_tpu_torch.data.sampler import PKBatchSampler

__all__ = ["ImageFolderIndex", "load_pair_list", "pair_image_names",
           "ArrayLoader", "Loader", "PKLoader", "PKBatchSampler",
           "PackedDataset", "PackedLoader", "pack_dataset", "PKRecLoader",
           "RecLoader", "RecordIODataset"]
