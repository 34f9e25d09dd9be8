"""Data sources of the port: identity trees, packs, RecordIO sets and
in-memory arrays, all behind the Loader contract (`steps_per_epoch()`,
`epoch(i)` -> uint8 NHWC images, int32 labels)."""

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
)
from face_recognition_models_tpu_torch.data.recordio import (
    RecLoader,
    RecordIODataset,
)

__all__ = ["ImageFolderIndex", "load_pair_list", "pair_image_names",
           "ArrayLoader", "Loader", "PackedDataset", "PackedLoader",
           "pack_dataset", "RecLoader", "RecordIODataset"]
