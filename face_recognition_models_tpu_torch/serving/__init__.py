"""Serving of the port: the exported embedder (torch.export), batch
embedding of an image tree, and the micro-batched HTTP service."""

from face_recognition_models_tpu_torch.serving.embed import (  # noqa: F401
    embed_directory,
    norm_quality,
)
from face_recognition_models_tpu_torch.serving.export import (  # noqa: F401
    EmbedderArtifact,
    export_embedder,
    load_embedder,
)
from face_recognition_models_tpu_torch.serving.server import (  # noqa: F401
    EmbedService,
    MicroBatcher,
    make_server,
)
