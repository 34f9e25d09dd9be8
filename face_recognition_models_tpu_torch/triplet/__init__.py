"""FaceNet triplet training of the port (PK batches, on-device semi-hard
mining)."""

from face_recognition_models_tpu_torch.triplet.train import (
    make_triplet_train_step,
    train_facenet,
)

__all__ = ["make_triplet_train_step", "train_facenet"]
